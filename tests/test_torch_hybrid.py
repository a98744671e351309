"""The hybrid family (jamba-1.5-large-398b) in the port against the JAX
package, on the jamba smoke config (8 layers = one superblock: attention,
7 Mamba layers, MoE on odd layers and SwiGLU on even ones; d_model 128,
4 heads of 32 over 2 KV heads, Mamba d_inner 256, d_state 16, 4 experts
top-2, DSA k 16 above min_n 8), float32 (and bfloat16 for the dtype
chain), with the JAX parameters from `init_params(PRNGKey(0))` carried
over through `repro_torch.bridge`; at 16 layers too, two superblocks, so
that a wrong superblock index shows.

The init's constant leaves (`conv_b` and `dt_bias` 0, `d_skip` 1,
`a_log` = log(1..16), every norm 1) would hide a misplaced bias, skip or
decay term, so the tests perturb them with seeded noise in the numpy
tree before it goes to both packages. States are made with numpy from
seeds.

Tolerances: float32 matmuls summed in other orders and exp/softplus/
sigmoid rounding in the last bit: `_mamba_step`'s output, `h` and `conv`
within rtol = atol = 1e-5; the step's logits (scale ~10) within rtol =
1e-5, atol = 5e-4 as llama's in `test_torch_model.py`; every float state
leaf within 1e-5; `prev_topk` (the Top-K, ascending indices) and
`length` exact. In bfloat16 both packages round at the same places (the
chain the module docstring states) but their bf16 matmuls and
elementwise kernels may round a value one bf16 ulp apart: outputs within
2^-6 relative to their scale, dtypes equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import hybrid
from repro_torch.models.api import build_model
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import layer_params
from repro_torch.serve import DecodeEngine

ARCH = "jamba-1.5-large-398b"
_MAMBA_CONSTANT = ("conv_b", "dt_bias", "d_skip", "a_log")


def _perturbed(jparams, seed=13):
    """The numpy tree with every constant leaf moved by seeded noise: the
    norms in 1 ± 0.3, `conv_b` and `dt_bias` ~ N(0, 0.5), `d_skip` 1 ±
    0.5, `a_log` ± 0.3."""
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(seed)

    def move(a, noise):
        return (a + noise(a.shape)).astype(a.dtype)

    norm = lambda shape: rng.uniform(-0.3, 0.3, shape)
    blocks = {k: dict(v) for k, v in tree["blocks"].items()}
    for part in ("attn", "mamba", "dense", "moe"):
        blocks[part]["ln"] = move(blocks[part]["ln"], norm)
    for name in _MAMBA_CONSTANT:
        noise = ((lambda s: rng.normal(0, 0.5, s)) if name in ("conv_b", "dt_bias")
                 else (lambda s: rng.uniform(-0.5, 0.5, s)) if name == "d_skip"
                 else (lambda s: rng.uniform(-0.3, 0.3, s)))
        blocks["mamba"][name] = move(blocks["mamba"][name], noise)
    return dict(tree, blocks=blocks, final_norm=move(tree["final_norm"], norm))


def _models(dtype="float32", n_layers=8):
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=dtype,
                               n_layers=n_layers)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                               n_layers=n_layers)
    jm = jax_build(jcfg)
    nparams = _perturbed(jm.init_params(jax.random.PRNGKey(0)))
    return (jm, jax.tree.map(jnp.asarray, nparams),
            build_model(tcfg, device="cpu"), bridge.params_from_numpy(nparams))


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def models16():
    return _models(n_layers=16)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """Key for key the reference's tree and nesting (`blocks` over
    superblocks; `mamba` over 7, `dense` and `moe` over 4 inside), each
    leaf of its shape and dtype, the constant leaves equal and every
    random leaf at the reference's scale (std within 10% of the JAX
    draw's); the bridge carries the tree leaf for leaf."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = jax.tree.map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tparams = build_model(tcfg, device="cpu").init_params(seed=0)
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert sorted(jl) == sorted(tl)
    assert tl[("blocks", "mamba", "in_proj")].shape[:2] == (1, 7)
    assert tl[("blocks", "moe", "w_gate")].shape[:2] == (1, 4)
    carried = dict(_leaves(bridge.params_from_numpy(jparams)))
    for path, want in jl.items():
        got = tl[path]
        assert tuple(got.shape) == want.shape, path
        assert _dtype(got) == str(want.dtype), path
        w, g = want.astype(np.float32), got.float().numpy()
        if w.std() == 0 or path[-1] == "a_log":
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, path
        assert carried[path].dtype == got.dtype
        np.testing.assert_array_equal(carried[path].float().numpy(), w)


def _close(got, want, dtype, name, tol=1e-5):
    """f32: within rtol = atol = tol; bf16: within 2^-6 of the scale."""
    assert _dtype(got) == str(want.dtype), name
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    else:
        assert np.abs(g - w).max() <= 2 ** -6 * np.abs(w).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_step_matches_jax(dtype):
    """Mamba layer 3's `_mamba_step` alone, stepped 3 times from a random
    state (x in the model dtype, h f32, conv in the model dtype), with the
    perturbed constants: the output, `h` and `conv` and their dtypes."""
    jm, jparams, tm, tparams = _models(dtype)
    jp = jax.tree.map(lambda a: a[0, 3], jparams["blocks"]["mamba"])
    tp = layer_params(layer_params(tparams["blocks"], 0)["mamba"], 3)
    cfg = tm.cfg
    di = cfg.d_model * cfg.mamba_expand
    rng = np.random.default_rng(5)
    b = 3
    h = rng.normal(size=(b, di, cfg.mamba_d_state)).astype(np.float32)
    conv = rng.normal(size=(b, cfg.mamba_d_conv - 1, di)).astype(np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    jc = jnp.asarray(conv).astype(dtype)
    tc = torch.from_numpy(conv).to(tparams["embed"].dtype)
    step = jax.jit(lambda p, x, h, c: jhybrid._mamba_step(p, x, h, c, jm.cfg))
    for t in range(3):
        x = rng.normal(size=(b, cfg.d_model)).astype(np.float32)
        j_out, jh, jc = step(jp, jnp.asarray(x).astype(dtype), jh, jc)
        t_out, th, tc = hybrid._mamba_step(
            tp, torch.from_numpy(x).to(tparams["embed"].dtype), th, tc, cfg)
        for got, want, name in ((t_out, j_out, "out"), (th, jh, "h"),
                                (tc, jc, "conv")):
            _close(got, want, dtype, f"{name} step {t}")


def _random_state(jm, tm, rng, b, max_len, lengths):
    """Both packages' initial states (equal leaf for leaf, the seeded
    `prev_topk` included), then random caches, `h` and `conv` and the
    given lengths."""
    js = jm.init_decode_state(b, max_len)
    ts = tm.init_decode_state(b, max_len)
    assert sorted(ts) == sorted(js)
    for key, want in js.items():
        assert _dtype(ts[key]) == str(want.dtype), key
        np.testing.assert_array_equal(ts[key].float().numpy(),
                                      np.asarray(want).astype(np.float32), key)
    for key in ("k", "v", "idx_k", "h", "conv"):
        a = rng.normal(size=js[key].shape).astype(np.float32)
        js[key] = jnp.asarray(a).astype(js[key].dtype)
        ts[key] = torch.from_numpy(a).to(ts[key].dtype)
    js["length"] = jnp.asarray(lengths, jnp.int32)
    ts["length"] = torch.tensor(lengths, dtype=torch.int32)
    return js, ts


@pytest.mark.parametrize("regime", ["dsa", "dense", "dsa-16-layers"])
def test_serve_step_matches_jax(models, models16, regime):
    """A 6-step loop from a random state through the DSA branch (max_len
    32 > min_n 8, lengths 0, 5, 20), the dense branch (max_len 8 <=
    min_n, lengths 0, 1, 2: `prev_topk` carried through, `idx_k` still
    written) and the DSA branch at 16 layers: logits, every state leaf,
    `prev_topk` exactly and `length` each step."""
    jm, jparams, tm, tparams = models16 if regime == "dsa-16-layers" else models
    rng = np.random.default_rng(17)
    b = 3
    max_len, lengths = (8, [0, 1, 2]) if regime == "dense" else (32, [0, 5, 20])
    js, ts = _random_state(jm, tm, rng, b, max_len, lengths)
    seed_topk = ts["prev_topk"].clone()
    step = jax.jit(jm.serve_step)
    for t in range(6):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, ts = tm.serve_step(tparams, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=5e-4, err_msg=f"logits step {t}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        assert sorted(ts) == sorted(js)
        for key in ("k", "v", "idx_k", "h", "conv"):
            assert _dtype(ts[key]) == str(js[key].dtype), key
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} step {t}")
        for key in ("prev_topk", "length"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                          err_msg=f"{key} step {t}")
    if regime == "dense":
        assert torch.equal(ts["prev_topk"], seed_topk)
    else:
        assert not torch.equal(ts["prev_topk"], seed_topk)


def test_bf16_dtype_chain_tracks_jax():
    """bfloat16, one superblock from one input, sub-layer by sub-layer:
    the attention layer, each Mamba layer and each feed-forward fed the
    same input in both packages (the JAX residual after each), every
    output of the JAX output's dtype and within 2^-6 of its scale."""
    jm, jparams, tm, tparams = _models("bfloat16")
    cfg = tm.cfg
    b = 2
    jb = jax.tree.map(lambda a: a[0], jparams["blocks"])
    tb = layer_params(tparams["blocks"], 0)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(b, cfg.d_model))).astype(jnp.bfloat16)

    def torch_of(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)

    js, ts = jm.init_decode_state(b, 32), tm.init_decode_state(b, 32)
    # at length 0 the one valid row is the token's own: attention gives v
    jv = (jlayers.rms_norm(x, jb["attn"]["ln"]) @ jb["attn"]["wv"]).reshape(
        b, cfg.n_kv_heads, cfg.hd)
    want = jnp.repeat(jv, cfg.n_heads // cfg.n_kv_heads, axis=1).astype(jnp.float32)
    tatt, _ = hybrid.attention_layer(tb["attn"], torch_of(x), ts, 0, cfg)
    _close(tatt, want, "bfloat16", "attention")
    x = x + want.reshape(b, -1).astype(jnp.bfloat16) @ jb["attn"]["wo"]
    for i in range(hybrid.SB):
        if i > 0:
            jp = jax.tree.map(lambda a: a[i - 1], jb["mamba"])
            tp = layer_params(tb["mamba"], i - 1)
            jy, jh, jc = jhybrid._mamba_step(jp, jlayers.rms_norm(x, jp["ln"]),
                                              js["h"][0, i - 1], js["conv"][0, i - 1],
                                              jm.cfg)
            ty, th, tc = hybrid._mamba_step(tp, rms_norm(torch_of(x), tp["ln"]),
                                            ts["h"][0, i - 1], ts["conv"][0, i - 1], cfg)
            for got, w, name in ((ty, jy, "out"), (th, jh, "h"), (tc, jc, "conv")):
                _close(got, w, "bfloat16", f"mamba {i} {name}")
            x = x + jy
        kind = "moe" if i % 2 else "dense"
        jp = jax.tree.map(lambda a: a[i // 2], jb[kind])
        tp = layer_params(tb[kind], i // 2)
        jn = jlayers.rms_norm(x, jp["ln"])
        jy = (jhybrid._ffn(jp, jn[:, None], jm.cfg, None, True)[:, 0] if kind == "moe"
              else jhybrid._ffn(jp, jn, jm.cfg, None, False))
        _close(hybrid._ffn(tp, rms_norm(torch_of(x), tp["ln"]), cfg, kind == "moe"),
               jy, "bfloat16", f"{kind} {i}")
        x = x + jy


def test_bf16_step_keeps_the_state_dtypes():
    """Four bfloat16 steps from the initial state: the state keeps the
    reference's dtypes (`h` f32, `length` and `prev_topk` int32, the rest
    bf16), `prev_topk` equal (every length is below K: the selection is
    every valid row, so no bf16 near-tie can split the packages' Top-K)
    and the logits finite, within relative L2 error 2^-2 of the JAX
    step's. That bound is loose on purpose: the sub-layers agree within
    an ulp (above), but the reference's expert scale (E^-0.5) gives each
    MoE layer a gain of ~5 on its input, so over the superblock's eight
    layers an ulp grows to a few per cent of the logits (relative L2
    error 0.018-0.125 in these four steps, the worst about half the
    bound)."""
    jm, jparams, tm, tparams = _models("bfloat16")
    b = 2
    js, ts = jm.init_decode_state(b, 32), tm.init_decode_state(b, 32)
    rng = np.random.default_rng(2)
    step = jax.jit(jm.serve_step)
    for t in range(4):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, ts = tm.serve_step(tparams, ts, torch.from_numpy(tok))
        w = np.asarray(jl)
        assert np.isfinite(tl.numpy()).all()
        assert np.linalg.norm(tl.numpy() - w) <= 2 ** -2 * np.linalg.norm(w), t
    assert {k: _dtype(v) for k, v in ts.items()} == \
        {k: str(v.dtype) for k, v in js.items()}
    assert ts["h"].dtype == torch.float32 and ts["conv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts["prev_topk"].numpy(), np.asarray(js["prev_topk"]))


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_engine_and_facade_refuse_the_family_as_jax(kv_layout):
    """Neither package's engine serves the hybrid family (no slot-wise or
    paged state hooks): the same ValueError for each layout; the facade's
    hooks raise the same NotImplementedError or give None, as the
    reference's; without a mesh a sequence-sharded step is the plain step,
    as the reference's (its SP path needs a mesh)."""
    jm = jax_build(jax_config(ARCH, smoke=True))
    tm = build_model(get_config(ARCH, smoke=True), device="cpu")
    tparams = tm.init_params(seed=0)
    msgs = []
    for engine, model, params in (
            (JaxEngine, jm, jm.init_params(jax.random.PRNGKey(0))),
            (DecodeEngine, tm, tparams)):
        with pytest.raises(ValueError) as err:
            engine(model, params, num_slots=2, max_len=64, page_size=8,
                   kv_layout=kv_layout)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert tm.state_batch_axes() is None is jm.state_batch_axes()
    assert tm.paged_state_batch_axes() is None is jm.paged_state_batch_axes()
    for call in (lambda m: m.init_paged_decode_state(2, 64, num_pages=16, page_size=8),
                 lambda m: m.reset_slot_state({}, 0),
                 lambda m: m.recycle_slot_state({}, 0)):
        texts = []
        for m in (jm, tm):
            with pytest.raises(NotImplementedError) as err:
                call(m)
            texts.append(str(err.value))
        assert texts[0] == texts[1]
    tok = torch.tensor([3, 7], dtype=torch.int32)
    states = [tm.init_decode_state(2, 32) for _ in range(2)]
    for st in states:
        st["length"] = torch.tensor([20, 11], dtype=torch.int32)
    plain, plain_st = tm.serve_step(tparams, states[0], tok)
    sp, sp_st = tm.serve_step(tparams, states[1], tok, seq_sharded=True)
    assert torch.equal(plain, sp)
    for k in plain_st:
        assert torch.equal(plain_st[k], sp_st[k]), k
