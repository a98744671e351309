"""The hybrid family's mesh step (jamba's smoke config) against the JAX
package's, with and without the sequence sharding of the attention layer.

4 gloo ranks on the CPU (`_sp_rank.py mesh`) and one JAX subprocess on 4
forced host devices (`_mesh_jax.py`), 3 greedy ticks each from a seeded
cache whose writes cross the sequence shards' boundary (N = 64 on 2
shards, lengths from 31):

* (2, 2), `seq_sharded`, at 4 KV heads (the reference's `ok_heads` is
  false there: it replicates the heads) equals the reference's (logits
  within 1e-4 of their scale, Top-K in the reference's order, tokens);
* (2, 2), `seq_sharded`, at the smoke config's 2 KV heads (`ok_heads`
  true): the reference groups each rank's 2 query heads over both KV
  heads and so attends with the wrong keys — its logits leave its own
  one-device step's by far more than rounding (pinned here: ROADMAP
  Queue C). The port keeps every query head with its own KV head: its
  logits equal the reference's one-device step, its Top-K the
  reference's sharded one in order (the selection precedes the
  attention);
* (2, 2) without sequence sharding, B = 2: the tensor- and
  expert-parallel step equals the reference's;
* (1, 4), `seq_sharded`, B = 1: the batch and the sequence both map to
  "data"; the reference's NamedSharding refuses it, and so does the port.
"""

from __future__ import annotations

import numpy as np
import pytest

from _sp_common import run_jax_and_ranks
from test_torch_mesh_step import _case_inputs, _close

TICKS = 3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_hybrid")
    rng = np.random.default_rng(26)
    arch = "jamba-1.5-large-398b"
    cases = {"gqa": (2, ["ref", "2x2sp", "1x4sp"], 1, [31]),
             "mha": (4, ["2x2sp"], 1, [31]),
             "tp": (2, ["2x2"], 2, [31, 40])}
    inp = {"cases": np.asarray(list(cases)), "ticks": np.asarray(TICKS)}
    for c, (kvh, run_names, b, lengths) in cases.items():
        inp.update(_case_inputs(rng, c, arch, run_names, b=b, lengths=lengths,
                                kvh=kvh))
    np.savez(tmp / "inputs.npz", **inp)
    return run_jax_and_ranks(open("tests/_mesh_jax.py").read(), "mesh", 4, tmp)


def _same_as(ranks, jax_out, c, run, ref_run, *, topk=True):
    for t in range(TICKS):
        for r, res in enumerate(ranks):
            got = res[f"{c}/{run}"]
            lo, hi = got["rows"]
            tick = got["ticks"][t]
            _close(tick["logits"].numpy(), jax_out[f"{c}/{ref_run}/logits{t}"][lo:hi],
                   (c, run, t, r))
            if topk:
                np.testing.assert_array_equal(
                    tick["prev_topk"].numpy(),
                    jax_out[f"{c}/{ref_run}/prev_topk{t}"][:, lo:hi],
                    err_msg=f"{c} {run} {t} {r}")
            np.testing.assert_array_equal(tick["tokens"].numpy(),
                                          jax_out[f"{c}/{ref_run}/tokens{t}"])


def test_sequence_sharded_with_replicated_heads_matches_jax(runs):
    """4 KV heads on (2, 2): the reference's `ok_heads` is false and it
    replicates the heads; the port's cache holds 2 KV heads a rank and
    it attends their 2 query heads: the same step."""
    jax_out, ranks = runs
    _same_as(ranks, jax_out, "mha", "2x2sp", "2x2sp")
    for res in ranks:
        bill = res["mha/2x2sp"]["ticks"][0]["bill"]
        assert {"data", "model"} <= set(bill), bill
        assert "wo" in bill["model"] and "combine" in bill["data"]
        assert not {"combine", "secant", "feedback"} & set(bill["model"])


def test_head_sharded_sp_keeps_each_head_with_its_kv_head(runs):
    jax_out, ranks = runs
    # the reference's fault: its head-sharded SP step is not its step
    gap = float(np.abs(jax_out["gqa/2x2sp/logits0"] - jax_out["gqa/ref/logits0"]).max())
    assert gap > 0.1, gap
    _same_as(ranks, jax_out, "gqa", "2x2sp", "ref", topk=False)
    for r, res in enumerate(ranks):
        tick = res["gqa/2x2sp"]["ticks"][0]
        np.testing.assert_array_equal(tick["prev_topk"].numpy(),
                                      jax_out["gqa/2x2sp/prev_topk0"], err_msg=r)
        for t in range(TICKS):
            np.testing.assert_array_equal(
                np.sort(res["gqa/2x2sp"]["ticks"][t]["prev_topk"].numpy(), -1),
                np.sort(jax_out[f"gqa/ref/prev_topk{t}"], -1))


def test_tensor_parallel_hybrid_step_matches_jax(runs):
    """B = 2 on (2, 2): a row a data rank; Mamba's channels, the dense
    FFN's d_ff, the experts and the heads over "model"."""
    jax_out, ranks = runs
    _same_as(ranks, jax_out, "tp", "2x2", "2x2")
    tags = set(ranks[0]["tp/2x2"]["ticks"][0]["bill"]["model"])
    assert {"in_proj", "x_proj", "out_proj", "ffn", "ep_dispatch", "wo",
            "embed", "logits"} <= tags, tags


def test_batch_and_sequence_on_one_axis_is_refused(runs):
    jax_out, ranks = runs
    assert str(jax_out["gqa/1x4sp/error"]) == "DuplicateSpecError"
    for res in ranks:
        assert "two dimensions" in res["gqa/1x4sp"]["error"]
