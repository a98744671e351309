"""The enc-dec family (whisper-medium) in the port against the JAX package,
on the whisper smoke config (2 + 2 layers, d_model 128, 4 heads of 32,
64 encoder frames, DSA k 16 above min_n 8), float32, with the JAX
parameters from `init_params(PRNGKey(0))` carried over through
`repro_torch.bridge`. Inputs, caches and the cross K/V are made with
numpy from seeds: the reference's `init_decode_state` leaves `ck`/`cv`
zero and no serve path fills them, so zeros would make the cross branch
vacuous.

Tolerances: float32 matmuls and softmax sums run in other orders in the
two frameworks, and their exp/tanh round in the last bit: `encode`'s
output (rms-normed, scale ~1) within rtol = atol = 1e-5, the step's
logits (scale ~10) within rtol = 1e-5, atol = 5e-4 as llama's in
`test_torch_model.py`, the written cache rows within 1e-5; `prev_topk`
(the Top-K, ascending indices), `length` and the untouched `ck`/`cv`
exact; greedy argmax equal. Both engines' and facades' refusal of the
enc-dec and the ssm family is held here too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import encdec, layers
from repro_torch.models.api import build_model
from repro_torch.serve import DecodeEngine

ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model, carried params) of the smoke
    config."""
    jm = jax_build(jax_config(ARCH, smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config(ARCH, smoke=True), device="cpu")
    return jm, jparams, tm, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """Key for key the reference's tree (the indexer under DSA), each leaf
    of its shape and dtype, the constant leaves equal and every random
    leaf at the reference's scale (std within 10% of the JAX draw's)."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = jax.tree.map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tparams = build_model(tcfg, device="cpu").init_params(seed=0)
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert sorted(jl) == sorted(tl)
    assert ("decoder", "indexer", "wq") in tl and ("enc_pos",) in tl
    for path, want in jl.items():
        got = tl[path]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        w, g = want.astype(np.float32), got.float().numpy()
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, path


def test_bridge_carries_the_tree_leaf_for_leaf():
    """bf16 weights and f32 norms and biases cross as they are."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(1)))
    tparams = bridge.params_from_numpy(jparams)
    for path, leaf in _leaves(jparams):
        node = dict(_leaves(tparams))[path]
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(), leaf.astype(np.float32))
    assert tparams["decoder"]["mlp"]["b_up"].dtype == torch.float32
    assert tparams["decoder"]["self_attn"]["wq"].dtype == torch.bfloat16


def test_gelu_mlp_is_the_tanh_form():
    rng = np.random.default_rng(3)
    x, w_up, w_down = (rng.normal(size=s).astype(np.float32)
                       for s in ((5, 16), (16, 32), (32, 16)))
    b_up, b_down = (rng.normal(size=s).astype(np.float32) for s in ((32,), (16,)))
    want = np.asarray(jlayers.gelu_mlp(*map(jnp.asarray, (x, w_up, b_up, w_down, b_down))))
    args = [torch.from_numpy(a) for a in (x, w_up, b_up, w_down, b_down)]
    np.testing.assert_allclose(layers.gelu_mlp(*args).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    erf = (torch.nn.functional.gelu(args[0] @ args[1] + args[2]) @ args[3]
           + args[4]).numpy()
    assert np.abs(erf - want).max() > 1e-4      # the erf form is another function


def test_encode_matches_jax(models):
    """The encoder over the config's 64 frames, B = 2."""
    jm, jparams, tm, tparams = models
    frames = np.random.default_rng(5).normal(
        size=(2, tm.cfg.encoder_frames, tm.cfg.d_model)).astype(np.float32)
    want = np.asarray(jencdec.encode(jparams, jnp.asarray(frames), jm.cfg))
    got = encdec.encode(tparams, torch.from_numpy(frames), tm.cfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _random_state(jm, tm, b, max_len, rng):
    """The same decode state in both packages: random K/V, indexer-K and
    cross K/V caches, lengths 0, 5 and up to 20 (DSA on slot 2 selects
    among more rows than K from the first step)."""
    js = jm.init_decode_state(b, max_len)
    ts = tm.init_decode_state(b, max_len)
    for key in ("k", "v", "ck", "cv", "idx_k"):
        a = rng.normal(size=js[key].shape).astype(np.float32)
        js[key], ts[key] = jnp.asarray(a), torch.from_numpy(a)
    lengths = np.array([0, 5, min(20, max_len)], np.int32)
    js["length"], ts["length"] = jnp.asarray(lengths), torch.from_numpy(lengths)
    np.testing.assert_array_equal(ts["prev_topk"].numpy(), np.asarray(js["prev_topk"]))
    return js, ts


@pytest.mark.parametrize("regime,max_len,min_n", [
    ("dsa", 48, None),          # N 48 > min_n 8: B5 -> B1 -> B6's plain versions
    ("dense", 48, 64),          # N <= min_n: plain attention, idx_k still written
    ("dense-clamped", 8, None),  # N = min_n: lengths run past N, rows clamp to N-1
])
def test_serve_step_matches_jax(models, regime, max_len, min_n):
    """A 14-step loop from one state: logits, every state leaf, and the
    Top-K exactly; rows whose write position passes N clamp to N-1."""
    jm, jparams, tm, tparams = models
    if min_n is not None:
        jm = jax_build(dataclasses.replace(
            jm.cfg, dsa=dataclasses.replace(jm.cfg.dsa, min_n=min_n)))
        tm = build_model(dataclasses.replace(
            tm.cfg, dsa=dataclasses.replace(tm.cfg.dsa, min_n=min_n)), device="cpu")
    rng = np.random.default_rng(7)
    b = 3
    js, ts = _random_state(jm, tm, b, max_len, rng)
    step = jax.jit(jm.serve_step)
    topk_moved = False
    for t in range(14):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        prev = ts["prev_topk"].clone()
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, ts = tm.serve_step(tparams, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=5e-4, err_msg=f"logits step {t}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        for key in ("prev_topk", "length"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                          err_msg=f"{key} step {t}")
        topk_moved |= not torch.equal(prev, ts["prev_topk"])
    assert sorted(ts) == sorted(js)
    for key in ("k", "v", "idx_k", "ck", "cv"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert topk_moved == (regime == "dsa")
    if regime == "dsa":
        idx = ts["prev_topk"]
        assert bool((idx[..., 1:] > idx[..., :-1]).all())      # ascending


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", [ARCH, "rwkv6-3b"])
def test_engine_and_facade_refuse_the_family_as_jax(arch, kv_layout):
    """Neither package's engine serves the enc-dec or the ssm family (no
    slot-wise or paged state hooks): the same ValueError for each layout;
    the facade's hooks raise the same NotImplementedError or give None,
    as the reference's."""
    jm = jax_build(jax_config(arch, smoke=True))
    tm = build_model(get_config(arch, smoke=True), device="cpu")
    msgs = []
    for engine, model, params in (
            (JaxEngine, jm, jm.init_params(jax.random.PRNGKey(0))),
            (DecodeEngine, tm, tm.init_params(seed=0))):
        with pytest.raises(ValueError) as err:
            engine(model, params, num_slots=2, max_len=64, page_size=8,
                   kv_layout=kv_layout)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("paged decode state" if kv_layout == "paged"
            else "slot-wise decode state") in msgs[1]
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
