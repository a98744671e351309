"""The SP-DSA layers of the port against the JAX package, at S = 2.

The port runs on 2 gloo ranks on the CPU (one process each, spawned here);
the JAX side in a subprocess with a forced 4-device host mesh. Held: the
paged layer `sp_dsa_decode_paged_local` on the llama smoke config and on
h2o-danube's sliding-window smoke config with the window straddling the
shard boundary — the Top-K buffer, SP-GVR iterations and telemetry equal,
attention within float32 rounding, every rank the same bits; and the
contiguous layer `sp_dsa_decode_local` (flash combine) likewise, with its
written cache shards.
"""

import numpy as np
import pytest
import torch

from _sp_common import paged_layouts, run_jax, run_ranks
from repro_torch.configs.registry import get_config

pytestmark = pytest.mark.mesh

ATTN_TOL = dict(rtol=2e-5, atol=2e-6)       # float32 rounding of the layer


def _inputs(rng):
    out = {}
    # the paged layer: llama (n 128) and danube (n 256, window 64: both
    # slots' windows straddle the boundary at 128)
    for c, arch, n, lengths in (("llama", "llama3.2-1b", 128, [100, 37]),
                                ("danube", "h2o-danube-3-4b", 256, [150, 170])):
        cfg = get_config(arch, smoke=True)
        lay = paged_layouts(rng, cfg, 2, n, 8, 2, lengths)
        for key in ("sp_k_pages", "sp_v_pages", "sp_idx_k_pages", "sp_table",
                    "length", "prev_topk", "topk_valid"):
            out[f"{c}_{key}"] = lay[key]
        d, hi, di = cfg.d_model, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim
        out[f"{c}_q"] = rng.standard_normal((2, cfg.n_heads, cfg.hd)).astype(np.float32)
        out[f"{c}_h"] = rng.standard_normal((2, d)).astype(np.float32)
        out[f"{c}_wq"] = (rng.standard_normal((d, hi * di)) * d ** -0.5).astype(np.float32)
        out[f"{c}_w"] = np.full((hi,), 1.0 / hi, np.float32)
    # the contiguous layer at llama's smoke widths: n 128 over 2 ranks
    cfg = get_config("llama3.2-1b", smoke=True)
    b, n, kvh, hd = 2, 128, cfg.n_kv_heads, cfg.hd
    out.update(
        c_q=rng.standard_normal((b, cfg.n_heads, hd)),
        c_kc=rng.standard_normal((b, n, kvh, hd)),
        c_vc=rng.standard_normal((b, n, kvh, hd)),
        c_ikc=rng.standard_normal((b, n, cfg.dsa.indexer_dim)),
        c_h=rng.standard_normal((b, cfg.d_model)),
        c_knew=rng.standard_normal((b, kvh, hd)),
        c_vnew=rng.standard_normal((b, kvh, hd)),
        c_iknew=rng.standard_normal((b, cfg.dsa.indexer_dim)))
    for key in list(out):
        if key.startswith("c_"):
            out[key] = out[key].astype(np.float32)
    out["c_lengths"] = np.array([90, 41], np.int32)
    out["c_prev"] = np.stack([np.sort(rng.choice(90, 16, replace=False)),
                              np.sort(rng.choice(41, 16, replace=False))]).astype(np.int32)
    return out


_JAX = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs.registry import get_config
from repro.launch.mesh import make_mesh
from repro.parallel.sharding import shard_map
from repro.sparse.sp_dsa import make_sp_dsa, sp_dsa_decode_paged_local

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}
mesh = make_mesh((2,), ("seq",))
for c, arch in (("llama", "llama3.2-1b"), ("danube", "h2o-danube-3-4b")):
    cfg = get_config(arch, smoke=True)
    kp, vp, ip = (inp[c + "_sp_" + k + "_pages"][0] for k in ("k", "v", "idx_k"))
    table = inp[c + "_sp_table"]
    b, mp = table.shape
    ps = kp.shape[2]
    span = mp // 2
    n_local = span * ps
    view = np.stack([np.concatenate([ip[lp // span, table[bb, lp]]
                                     for lp in range(mp)]) for bb in range(b)])
    kk = inp[c + "_prev_topk"].shape[-1]

    def fn(q, kp, vp, tl, wq, w, h, iv, prev, valid, lengths):
        my = jax.lax.axis_index("seq")
        r = sp_dsa_decode_paged_local(
            q, kp[0], vp[0], tl, {"wq": wq, "w": w}, h, iv, prev, valid,
            lengths, k=kk, scale=cfg.hd ** -0.5,
            heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
            rope_base=cfg.rope_base,
            shard_offset=(my * n_local).astype(jnp.int32), page_size=ps,
            max_candidates=cfg.dsa.max_candidates, swa_window=cfg.swa_window,
            seq_axis="seq")
        return r.attn_out, r.new_topk, r.secant_iters, r.gvr_rows

    f = jax.jit(shard_map(fn, mesh=mesh,
                  in_specs=(P(), P("seq"), P("seq"), P(None, "seq"), P(), P(),
                            P(), P(None, "seq", None), P(), P(), P()),
                  out_specs=(P(), P(), P(), P()), check_vma=False))
    res = f(*map(jnp.asarray, (inp[c + "_q"], kp, vp, table, inp[c + "_wq"],
                               inp[c + "_w"], inp[c + "_h"], view,
                               inp[c + "_prev_topk"][0],
                               inp[c + "_topk_valid"][0], inp[c + "_length"])))
    for key, v in zip(("attn", "topk", "iters", "gvr"), res):
        out[f"{c}_{key}"] = np.asarray(v)

cfg = get_config("llama3.2-1b", smoke=True)
layer = make_sp_dsa(mesh, k=16, scale=cfg.hd ** -0.5,
                    heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
                    rope_base=cfg.rope_base, seq_axis="seq", shard_heads=False)
res = jax.jit(layer)(*map(jnp.asarray, (inp["c_q"], inp["c_kc"], inp["c_vc"],
                               inp["c_ikc"], inp["c_h"])),
            {"wq": jnp.asarray(inp["llama_wq"]), "w": jnp.asarray(inp["llama_w"])},
            *map(jnp.asarray, (inp["c_prev"], inp["c_lengths"], inp["c_knew"],
                               inp["c_vnew"], inp["c_iknew"])))
for key, v in zip(("out", "kc", "vc", "ikc", "topk"), res):
    out["contig_" + key] = np.asarray(v)
np.savez(tmp + "/jax.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_dsa")
    inputs = _inputs(np.random.default_rng(11))
    np.savez(tmp / "inputs.npz", **inputs)
    jax_out = run_jax(_JAX, tmp)
    port = run_ranks("dsa", 2, tmp)
    return inputs, jax_out, port


@pytest.mark.parametrize("config", ["llama", "danube"])
def test_sp_dsa_paged_layer_equals_jax(runs, config):
    """The paged layer at S = 2: the ascending Top-K buffer, SP-GVR's
    iterations and the GVR rows equal JAX's, attention within float32
    rounding, every rank the same bits. danube's windows straddle the
    boundary: the selection stays inside [length - 64, length)."""
    inputs, jax_out, port = runs
    outs = [r[config] for r in port]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    attn, topk, iters, gvr = outs[0]
    np.testing.assert_array_equal(topk.numpy(), jax_out[f"{config}_topk"])
    np.testing.assert_array_equal(iters.numpy(), jax_out[f"{config}_iters"])
    np.testing.assert_array_equal(gvr.numpy(), jax_out[f"{config}_gvr"])
    np.testing.assert_allclose(attn.numpy(), jax_out[f"{config}_attn"], **ATTN_TOL)
    if config == "danube":
        lengths = inputs["danube_length"][:, None]
        sel = topk.numpy()
        assert ((sel >= lengths - 64) & (sel < lengths)).all()
        assert ((sel < 128).any(1) & (sel >= 128).any(1)).all()


def test_sp_dsa_contiguous_layer_equals_jax(runs):
    """The contiguous layer at S = 2: the written cache shards
    concatenated equal JAX's caches, the next Top-K is equal, attention
    (the flash combine) within float32 rounding."""
    _, jax_out, port = runs
    outs = [r["contig"] for r in port]
    for i, key in ((1, "kc"), (2, "vc"), (3, "ikc")):
        np.testing.assert_array_equal(
            torch.cat([o[i] for o in outs], 1).numpy(), jax_out["contig_" + key])
    for o in outs:
        np.testing.assert_array_equal(o[4].numpy(), jax_out["contig_topk"])
        np.testing.assert_allclose(o[0].numpy(), jax_out["contig_out"], **ATTN_TOL)


