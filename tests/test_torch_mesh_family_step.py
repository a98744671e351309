"""The enc-dec and ssm families' decode steps on a ("data", "model") mesh,
and jamba's sequence-sharded step on a short cache, against the JAX
package's.

4 gloo ranks on the CPU (`_sp_rank.py mesh`) and one JAX subprocess on 4
forced host devices (`_mesh_jax.py`), 3 greedy ticks each from a seeded
state, as `test_torch_mesh_step.py` holds the transformer family:

* whisper-medium's smoke config on (2, 2) and (1, 4), N = 64 past
  `dsa.min_n` (DSA on the rank's KV heads) with random cross K/V: Top-K
  indices in the reference's order, tokens equal, logits within 1e-4 of
  their scale;
* rwkv6-3b's on (2, 2) and (1, 4): tokens and logits;
* jamba's with `seq_sharded` on (2, 2) at N = 8 = `dsa.min_n`, one row
  over a cache split in two spans, the writes crossing from one to the
  other: the dense attention over the sharded sequence equals the
  reference's step, which falls back to its unsharded path there.
"""

from __future__ import annotations

import numpy as np
import pytest

from _sp_common import flatten, run_jax_and_ranks
from test_torch_mesh_step import _close, _jax_model

TICKS = 3
CASES = {"whisper": ("whisper-medium", ["ref", "2x2", "1x4"], [40, 17, 55, 30], 64),
         "rwkv6": ("rwkv6-3b", ["ref", "2x2", "1x4"], [40, 17, 55, 30], 64),
         "jamba": ("jamba-1.5-large-398b", ["ref", "2x2sp"], [3], 8)}


def _inputs(rng, c, arch, runs, lengths, n):
    model, params = _jax_model(arch, None)
    cfg = model.cfg
    b = len(lengths)
    state = {k: np.asarray(v) for k, v in model.init_decode_state(b, n).items()}
    for k, v in state.items():
        if v.dtype.kind == "f":
            state[k] = rng.standard_normal(v.shape).astype(v.dtype)
    state["length"] = np.asarray(lengths, np.int32)
    out = {f"{c}/arch": np.asarray(arch), f"{c}/kvh": np.asarray(cfg.n_kv_heads),
           f"{c}/runs": np.asarray(runs),
           f"{c}/tokens": rng.integers(0, cfg.vocab, (b,)).astype(np.int32)}
    out.update(flatten(params, f"{c}/params/"))
    out.update(flatten(state, f"{c}/state/"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_family_step")
    rng = np.random.default_rng(27)
    inp = {"cases": np.asarray(list(CASES)), "ticks": np.asarray(TICKS)}
    for c, (arch, run_names, lengths, n) in CASES.items():
        inp.update(_inputs(rng, c, arch, run_names, lengths, n))
    np.savez(tmp / "inputs.npz", **inp)
    return run_jax_and_ranks(open("tests/_mesh_jax.py").read(), "mesh", 4, tmp)


def _same(jax_out, ranks, c, run, ref_run):
    for t in range(TICKS):
        for r, res in enumerate(ranks):
            got = res[f"{c}/{run}"]
            lo, hi = got["rows"]
            tick = got["ticks"][t]
            _close(tick["logits"].numpy(),
                   jax_out[f"{c}/{ref_run}/logits{t}"][lo:hi], (c, run, t, r))
            if f"{c}/{ref_run}/prev_topk{t}" in jax_out:
                np.testing.assert_array_equal(
                    tick["prev_topk"].numpy(),
                    jax_out[f"{c}/{ref_run}/prev_topk{t}"][:, lo:hi],
                    err_msg=f"{c} {run} {t} {r}")
            np.testing.assert_array_equal(tick["tokens"].numpy(),
                                          jax_out[f"{c}/{ref_run}/tokens{t}"])


@pytest.mark.parametrize("run", ["2x2", "1x4"])
@pytest.mark.parametrize("c", ["whisper", "rwkv6"])
def test_family_mesh_step_matches_jax_mesh_step(runs, c, run):
    jax_out, ranks = runs
    for t in range(TICKS):
        np.testing.assert_array_equal(jax_out[f"{c}/{run}/tokens{t}"],
                                      jax_out[f"{c}/ref/tokens{t}"])
    _same(jax_out, ranks, c, run, run)


def test_family_mesh_step_places_by_the_specs(runs):
    """whisper on (1, 4): a KV head, a quarter of d_ff and of the
    vocabulary a rank, every row; DSA ran (Top-K recorded). rwkv6 on
    (2, 2): half the rows, wr's columns and cv's rows; the WKV state
    keeps every head."""
    jax_out, ranks = runs
    for r, res in enumerate(ranks):
        w = res["whisper/1x4"]
        assert w["rows"] == (0, 4)
        assert w["shapes"]["decoder/self_attn/wk"] == (2, 128, 32)
        assert w["shapes"]["decoder/mlp/w_up"] == (2, 128, 64)
        assert w["shapes"]["embed"] == (128, 128)
        assert w["ticks"][0]["prev_topk"].shape == (2, 4, 16)
        assert {"wo", "ffn", "logits", "embed"} <= set(w["ticks"][0]["bill"]["model"])
        s = res["rwkv6/2x2"]
        assert s["rows"] == ((r // 2) * 2, (r // 2) * 2 + 2)
        assert s["shapes"]["layers/wr"] == (2, 128, 64)
        assert s["shapes"]["layers/cv"] == (2, 128, 128)
        assert {"wr", "wo", "cv", "logits"} <= set(s["ticks"][0]["bill"]["model"])


def test_hybrid_sequence_sharded_short_cache_matches_jax(runs):
    jax_out, ranks = runs
    _same(jax_out, ranks, "jamba", "2x2sp", "2x2sp")
    _same(jax_out, ranks, "jamba", "2x2sp", "ref")
    for res in ranks:
        bill = res["jamba/2x2sp"]["ticks"][0]["bill"]
        assert "combine" in bill["data"], bill
        assert not {"secant", "feedback"} & set(bill["data"]), bill
