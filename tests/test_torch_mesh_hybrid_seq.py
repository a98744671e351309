"""jamba's sequence-sharded step on (4, 1) against the JAX package's:
SP-DSA over four "data" ranks with no head sharding.

4 gloo ranks on the CPU (`_sp_rank.py mesh`) and one JAX subprocess on 4
forced host devices (`_mesh_jax.py`), 3 greedy ticks from a seeded cache
of N = 64 positions in four spans of 16, one row whose writes cross from
the second span into the third (lengths from 31). The batch of one row
does not divide "data", so it is replicated and the sequence alone is
sharded there. On (4, 1) the reference's `ok_heads` holds with every
head on each rank (a "model" axis of one), so its step is its one-device
step: the port's logits within 1e-4 of their scale of both, its Top-K
the reference's set, its tokens equal. The (2, 2) and (1, 4) cases
stay in `test_torch_mesh_hybrid.py`.
"""

from __future__ import annotations

import numpy as np
import pytest

from _sp_common import run_jax_and_ranks
from test_torch_mesh_hybrid import TICKS, _same_as
from test_torch_mesh_step import _case_inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_hybrid_seq")
    rng = np.random.default_rng(28)
    inp = {"cases": np.asarray(["sp4"]), "ticks": np.asarray(TICKS)}
    inp.update(_case_inputs(rng, "sp4", "jamba-1.5-large-398b",
                            ["ref", "4x1sp"], b=1, lengths=[31], kvh=2))
    np.savez(tmp / "inputs.npz", **inp)
    return run_jax_and_ranks(open("tests/_mesh_jax.py").read(), "mesh", 4, tmp)


def test_sequence_sharded_on_four_data_ranks_matches_jax(runs):
    """Logits and tokens as above; the Top-K as a set. Its order is the
    shards' in turn, each shard's positions above the K-th score first,
    then those equal to it: where one side's K-th score equals a
    position's and the other's lies an ulp below (the scores sum in
    other orders), that position moves within its shard's list."""
    jax_out, ranks = runs
    _same_as(ranks, jax_out, "sp4", "4x1sp", "4x1sp", topk=False)
    _same_as(ranks, jax_out, "sp4", "4x1sp", "ref", topk=False)
    for res in ranks:
        for t in range(TICKS):
            np.testing.assert_array_equal(
                np.sort(res["sp4/4x1sp"]["ticks"][t]["prev_topk"].numpy(), -1),
                np.sort(jax_out[f"sp4/4x1sp/prev_topk{t}"], -1), err_msg=t)


def test_sequence_sharded_on_four_data_ranks_bills_the_sequence_axis(runs):
    """Each rank holds a quarter of the sequence and every KV head; the
    SP-GVR selection and the combine run over "data" alone."""
    _, ranks = runs
    for res in ranks:
        run = res["sp4/4x1sp"]
        assert run["rows"] == (0, 1)
        bill = run["ticks"][0]["bill"]
        assert set(bill) == {"data"}, bill
        assert {"combine", "feedback"} <= set(bill["data"]), bill


LOOP_CAPS = {"secant": 12, "hist": 10, "snap": 32, "fallback": 1}


def test_sequence_sharded_shadow_bill_equals_live(runs):
    """The dry run's shadow step (`launch.dryrun.shadow_step` on the meta
    device under a `ShadowMesh`) at this file's mesh, config and shapes:
    on every rank, each tag whose count does not depend on the data bills
    the live first tick's calls and bytes; SP-GVR's data-dependent loops
    (secant, histogram, snap rounds and the fallback gather) bill their
    cap a layer, at least the live count."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import AbstractMesh, make_rules
    _, ranks = runs
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True),
                              n_kv_heads=2)
    mesh = AbstractMesh((4, 1), ("data", "model"))
    model = build_model(cfg, device="meta")
    cell = {"kind": "decode", "seq_len": 64, "global_batch": 1,
            "seq_sharded": True}
    n_attn = cfg.n_layers // cfg.attn_every
    for r, res in enumerate(ranks):
        shadow = dryrun.shadow_step(model, cell, mesh, make_rules(mesh),
                                    coords={"data": r})["bill"]
        live = res["sp4/4x1sp"]["ticks"][0]["bill"]
        assert set(shadow) == set(live) == {"data"}
        got, want = shadow["data"], live["data"]
        assert set(LOOP_CAPS) <= set(got) and set(want) <= set(got)
        for tag, bill in got.items():
            if tag in LOOP_CAPS:
                assert bill["calls"] == n_attn * LOOP_CAPS[tag], tag
                live_bill = want.get(tag, {"calls": 0, "bytes": 0})
                assert bill["calls"] >= live_bill["calls"], tag
                assert bill["bytes"] >= live_bill["bytes"], tag
            else:
                assert bill == want[tag], (r, tag)
