"""The tensor- and expert-parallel decode step against the JAX package's.

llama3.2-1b's and moonshot-v1-16b-a3b's smoke configs step 3 greedy ticks
on a port (2, 2) ("data", "model") mesh of 4 gloo ranks on the CPU
(`_sp_rank.py mesh`), each rank holding the blocks its specs give it,
against JAX's `serve_step(mesh=make_mesh((2, 2)), rules=make_rules(mesh))`
on 4 forced host devices (`_mesh_jax.py`), from the same parameters and a
seeded cache past `dsa.min_n`. Tokens and Top-K indices are equal; logits
agree within 1e-4 of their scale (float32: the sharded contractions sum
in another order than one device, on both sides). `moe_mlp_ep` is held
against the reference's at a token count whose routing overflows the
capacity (drops > 0, the same count) and at a decode batch that does not
divide the data axis (tokens replicated). One JAX subprocess and one rank
spawn serve the whole file.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest

from _sp_common import flatten, run_jax_and_ranks

from repro.configs.registry import get_config as jget_config
from repro.models.api import build_model as jbuild

TICKS = 3
CASES = {"llama": "llama3.2-1b", "moonshot": "moonshot-v1-16b-a3b"}
LENGTHS = [40, 17, 55, 30]
N = 64
TOL = 1e-4
BF16_TOL = 2e-2


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kvh):
    """The reference model and its seed-0 parameters (numpy), once a
    config."""
    cfg = jget_config(arch, smoke=True)
    if kvh is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kvh)
    model = jbuild(cfg)
    return model, jax.tree.map(np.asarray, jax.jit(model.init_params)(
        jax.random.PRNGKey(0)))


def _case_inputs(rng, c, arch, runs, *, b, lengths, kvh=None, n=N):
    model, params = _jax_model(arch, kvh)
    cfg = model.cfg
    state = {k: np.asarray(v) for k, v in model.init_decode_state(b, n).items()}
    for k in ("k", "v", "idx_k"):
        state[k] = rng.standard_normal(state[k].shape).astype(np.float32)
    state["length"] = np.asarray(lengths, np.int32)
    out = {f"{c}/arch": np.asarray(arch), f"{c}/kvh": np.asarray(cfg.n_kv_heads),
           f"{c}/runs": np.asarray(runs),
           f"{c}/tokens": rng.integers(0, cfg.vocab, (b,)).astype(np.int32)}
    out.update(flatten(params, f"{c}/params/"))
    out.update(flatten(state, f"{c}/state/"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_step")
    rng = np.random.default_rng(25)
    inp = {"cases": np.asarray(list(CASES)), "ticks": np.asarray(TICKS)}
    for c, arch in CASES.items():
        inp.update(_case_inputs(rng, c, arch, ["ref", "2x2"], b=4,
                                lengths=LENGTHS))
    mmodel, jp = _jax_model("moonshot-v1-16b-a3b", None)
    mcfg = mmodel.cfg
    for k in ("router", "w_gate", "w_up", "w_down"):
        inp["ep/" + k] = jp["layers"][k][1]
    inp["ep/top_k"] = np.asarray(mcfg.moe.top_k)
    inp["ep/cf"] = np.asarray(mcfg.moe.capacity_factor)
    # 4 rows of 16 tokens: 2 data shards of 32 tokens, 2 EP slices of 16
    # (48 assignments over 8 experts against a capacity of 7 each)
    inp["ep/x_drop"] = rng.standard_normal((4, 16, mcfg.d_model)).astype(np.float32)
    inp["ep/x_dec"] = rng.standard_normal((3, 1, mcfg.d_model)).astype(np.float32)
    np.savez(tmp / "inputs.npz", **inp)
    jax_out, ranks = run_jax_and_ranks(open("tests/_mesh_jax.py").read(),
                                       "mesh", 4, tmp)
    return jax_out, ranks


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_step_matches_jax_mesh_step(runs, c):
    jax_out, ranks = runs
    for t in range(TICKS):
        want = jax_out[f"{c}/2x2/logits{t}"]
        # the reference's mesh step equals its one-device step
        np.testing.assert_array_equal(jax_out[f"{c}/2x2/tokens{t}"],
                                      jax_out[f"{c}/ref/tokens{t}"])
        for r, res in enumerate(ranks):
            run = res[f"{c}/2x2"]
            lo, hi = run["rows"]
            tick = run["ticks"][t]
            _close(tick["logits"].numpy(), want[lo:hi], (c, t, r))
            np.testing.assert_array_equal(
                tick["prev_topk"].numpy(),
                jax_out[f"{c}/2x2/prev_topk{t}"][:, lo:hi], err_msg=f"{c} {t} {r}")
            np.testing.assert_array_equal(tick["tokens"].numpy(),
                                          jax_out[f"{c}/2x2/tokens{t}"])


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_step_shards_weights_rows_and_collectives(runs, c):
    """On (2, 2) each rank holds half of wq's columns, wo's rows, the
    FFN's d_ff (llama) or the experts (moonshot) and the vocab, and 2 of
    the 4 batch rows; the step's collectives run over "model" alone
    (embed, wo, ffn or the EP exchanges, logits)."""
    jax_out, ranks = runs
    cfg = jget_config(CASES[c], smoke=True)
    d, hd = cfg.d_model, cfg.hd
    for r, res in enumerate(ranks):
        run = res[f"{c}/2x2"]
        sh = run["shapes"]
        assert run["rows"] == ((r // 2) * 2, (r // 2) * 2 + 2)
        assert sh["layers/wq"] == (cfg.n_layers, d, cfg.n_heads * hd // 2)
        assert sh["layers/wo"] == (cfg.n_layers, cfg.n_heads * hd // 2, d)
        assert sh["embed"] == (cfg.vocab // 2, d)
        assert sh["layers/indexer/wq"][2] == cfg.dsa.indexer_heads * cfg.dsa.indexer_dim
        if cfg.moe.num_experts:
            assert sh["layers/w_gate"][1] == cfg.moe.num_experts // 2
            tags = {"embed", "wo", "ep_dispatch", "ep_return", "ep_tokens", "logits"}
        else:
            assert sh["layers/w_gate"][2] == cfg.d_ff // 2
            assert sh["layers/w_down"][1] == cfg.d_ff // 2
            tags = {"embed", "wo", "ffn", "logits"}
        bill = run["ticks"][0]["bill"]
        assert set(bill) == {"model"} and set(bill["model"]) == tags, bill
        assert bill["model"]["wo"]["calls"] == cfg.n_layers
        assert res["ep/bill"]["model"]["ep_dispatch"]["calls"] == 2


def test_moe_mlp_ep_matches_jax_with_drops(runs):
    jax_out, ranks = runs
    want = jax_out["ep/x_drop"]
    drops = sum(res["ep/x_drop"][2] for r, res in enumerate(ranks) if r % 2 == 0)
    assert drops > 0
    assert drops == int(jax_out["ep/x_drop_drops"])
    assert not np.allclose(want, jax_out["ep/x_drop_dense"], atol=1e-3)
    for res in ranks:
        (lo, hi), got, _ = res["ep/x_drop"]
        _close(got.numpy(), want[lo:hi], "x_drop")


def test_moe_mlp_ep_matches_jax_in_bf16(runs):
    """The same tokens in bf16 with bf16 experts and the f32 router, the
    dtypes moonshot serves in: the gate multiply and the top-k sum round
    in bf16 in the reference's order; equal drops, and outputs within
    bf16 rounding (BF16_TOL of their scale: the two sides' products
    accumulate in other orders)."""
    jax_out, ranks = runs
    want = jax_out["ep/x_drop_bf16"]
    drops = sum(res["ep/x_drop_bf16"][2] for r, res in enumerate(ranks)
                if r % 2 == 0)
    assert drops > 0
    assert drops == int(jax_out["ep/x_drop_bf16_drops"])
    scale = float(np.abs(want).max())
    for res in ranks:
        (lo, hi), got, _ = res["ep/x_drop_bf16"]
        err = float(np.abs(got.numpy() - want[lo:hi]).max())
        assert err <= BF16_TOL * scale, (err, scale)


def test_moe_mlp_ep_replicates_a_decode_batch_that_does_not_divide(runs):
    """3 rows on 2 data ranks: every rank routes all of them, as the
    reference's shard_map replicates them; nothing drops at this size,
    so it is also the dense fallback."""
    jax_out, ranks = runs
    assert int(jax_out["ep/x_dec_drops"]) == 0
    for res in ranks:
        (lo, hi), got, drops = res["ep/x_dec"]
        assert (lo, hi) == (0, 3) and drops == 0
        _close(got.numpy(), jax_out["ep/x_dec"], "x_dec")
        _close(got.numpy(), jax_out["ep/x_dec_dense"], "x_dec vs dense")


def test_all_to_all_as_lax(runs):
    """`MeshAxis.all_to_all` on the "model" axis of 2 ranks, tiled and
    not, over several split and concat axes: rank j receives block j of
    every rank's buffer, joined (or stacked) in rank order, as
    `lax.all_to_all` defines it (gloo builds it from an all-gather)."""
    _, ranks = runs
    base = np.arange(2 * 4 * 6, dtype=np.float32).reshape(2, 4, 6) * 10
    for res in ranks:
        me, got = res["all_to_all"]
        for (split, concat, tiled), out in got.items():
            blocks = [np.split(base + i, 2, axis=split)[me] for i in range(2)]
            if tiled:
                want = np.concatenate(blocks, axis=concat)
            else:
                want = np.stack([b.squeeze(split) for b in blocks], axis=concat)
            np.testing.assert_array_equal(out.numpy(), want,
                                          err_msg=str((split, concat, tiled)))


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_step_shadow_bill_equals_live(runs, c):
    """The dry run's shadow step (`launch.dryrun.shadow_step`: rank r's
    step on the meta device under a `ShadowMesh`) at this file's mesh,
    config and shapes bills each rank's first tick exactly: every tag's
    calls and bytes (no tag of the decode step depends on the data)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import AbstractMesh, make_rules
    _, ranks = runs
    cfg = get_config(CASES[c], smoke=True)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    model = build_model(cfg, device="meta")
    cell = {"kind": "decode", "seq_len": N, "global_batch": len(LENGTHS)}
    for r, res in enumerate(ranks):
        shadow = dryrun.shadow_step(model, cell, mesh, make_rules(mesh),
                                    coords={"data": r // 2, "model": r % 2})
        assert shadow["bill"] == res[f"{c}/2x2"]["ticks"][0]["bill"], r
        assert shadow["outputs"][0] == [2, cfg.vocab]
