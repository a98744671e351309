"""The ssm family (rwkv6-3b) in the port against the JAX package, on the
rwkv6 smoke config (2 layers, d_model 128, 2 heads of 64, d_ff 256),
float32 (and bfloat16 for the dtype chain), with the JAX parameters from
`init_params(PRNGKey(0))` carried over through `repro_torch.bridge`.

The init's constant leaves (`u` = 0, `w0` = -0.5, every `mix_*` = 0.5)
would leave the bonus term vacuous and every token shift an even
average, so the tests perturb them with seeded noise in the numpy tree
before it goes to both packages. Inputs and states are made with numpy
from seeds.

Tolerances: float32 matmuls summed in other orders and exp/tanh/sigmoid
rounding in the last bit: the mixes' outputs within rtol = atol = 1e-5,
the step's logits (scale ~10) within rtol = 1e-5, atol = 5e-4 as llama's
in `test_torch_model.py`, the recurrent state within 1e-5, `length`
exact. In bfloat16 both packages round at the same places (the chain
the module docstring states) but their bf16 elementwise kernels round
differently (about half the outputs one bf16 ulp apart): outputs within
2^-6 relative to their scale, dtypes equal; the f32 WKV state within
rtol = atol = 1e-4 (observed ~1e-6: its bf16 inputs k, v and the decay's
LoRA agree, so a state updated in bf16 or a decay rounded elsewhere
shows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import ssm as jssm
from repro.models.api import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import ssm
from repro_torch.models.api import build_model
from repro_torch.models.transformer import layer_params

ARCH = "rwkv6-3b"
_CONSTANT = ("u", "w0", "mix_r", "mix_k", "mix_v", "mix_w", "mix_g",
             "mix_ck", "mix_cr")


def _perturbed(jparams, seed=11):
    """The numpy tree with every constant leaf moved by seeded noise:
    mixes in (0, 1), w0 around -0.5, the bonus u ~ N(0, 0.5)."""
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for name in _CONSTANT:
        a = layers[name]
        noise = rng.uniform(-0.4, 0.4, a.shape) if name.startswith("mix") \
            else rng.normal(0, 0.5, a.shape)
        layers[name] = (a + noise).astype(a.dtype)
    return dict(tree, layers=layers)


def _models(dtype="float32"):
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jm = jax_build(jcfg)
    nparams = _perturbed(jm.init_params(jax.random.PRNGKey(0)))
    return (jm, jax.tree.map(jnp.asarray, nparams),
            build_model(tcfg, device="cpu"), bridge.params_from_numpy(nparams))


@pytest.fixture(scope="module")
def models():
    return _models()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """Key for key the reference's tree, each leaf of its shape and
    dtype, the constant leaves equal and every random leaf at the
    reference's scale (std within 10% of the JAX draw's); the bridge
    carries the tree leaf for leaf."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jparams = jax.tree.map(np.asarray, jax_build(jcfg).init_params(
        jax.random.PRNGKey(0)))
    tparams = build_model(tcfg, device="cpu").init_params(seed=0)
    jl, tl = dict(_leaves(jparams)), dict(_leaves(tparams))
    assert sorted(jl) == sorted(tl)
    carried = dict(_leaves(bridge.params_from_numpy(jparams)))
    for path, want in jl.items():
        got = tl[path]
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        w, g = want.astype(np.float32), got.float().numpy()
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert abs(g.std() / w.std() - 1) < 0.1, path
        assert carried[path].dtype == got.dtype
        np.testing.assert_array_equal(carried[path].float().numpy(), w)


def _mix_inputs(cfg, rng, b=3):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rng.normal(size=(b, d)).astype(np.float32)
    x_prev = rng.normal(size=(b, d)).astype(np.float32)
    s = rng.normal(size=(b, d // hd, hd, hd)).astype(np.float32)
    return x, x_prev, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_and_channel_mix_match_jax(dtype):
    """Layer 1's `_time_mix_step` and `_channel_mix_step` alone on random
    inputs (x in the model dtype, the previous input and s in f32), with
    the perturbed constants: outputs, the new WKV state and their dtypes."""
    jm, jparams, tm, tparams = _models(dtype)
    jp = jax.tree.map(lambda a: a[1], jparams["layers"])
    tp = layer_params(tparams["layers"], 1)
    x, x_prev, s = _mix_inputs(tm.cfg, np.random.default_rng(4))
    jx = jnp.asarray(x).astype(jm.cfg.dtype)
    tx = torch.from_numpy(x).to(tparams["embed"].dtype)
    j_out, j_s = jssm._time_mix_step(jp, jx, jnp.asarray(x_prev), jnp.asarray(s), jm.cfg)
    t_out, t_s = ssm._time_mix_step(tp, tx, torch.from_numpy(x_prev),
                                    torch.from_numpy(s), tm.cfg)
    j_c = jssm._channel_mix_step(jp, jx, jnp.asarray(x_prev))
    t_c = ssm._channel_mix_step(tp, tx, torch.from_numpy(x_prev))
    for got, want, name in ((t_out, j_out, "time mix"), (t_s, j_s, "state"),
                            (t_c, j_c, "channel mix")):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
        if dtype == "float32" or name == "state":
            tol = 1e-5 if dtype == "float32" else 1e-4
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2 ** -6 * np.abs(w).max(), name


def test_serve_step_matches_jax(models):
    """A 16-step loop from a random state: logits, `s`, `x_att`, `x_ffn`
    and `length` every step; the step leaves its input state untouched."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(9)
    b = 3
    js = jm.init_decode_state(b, 64)
    ts = tm.init_decode_state(b, 64)
    assert sorted(ts) == sorted(js)
    for key in ("s", "x_att", "x_ffn"):
        a = rng.normal(size=js[key].shape).astype(np.float32)
        js[key], ts[key] = jnp.asarray(a), torch.from_numpy(a)
    step = jax.jit(jm.serve_step)
    for t in range(16):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        before = {k: v.clone() for k, v in ts.items()}
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, new = tm.serve_step(tparams, ts, torch.from_numpy(tok))
        for key, v in ts.items():
            assert torch.equal(v, before[key]), key
        ts = new
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=5e-4, err_msg=f"logits step {t}")
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
        for key in ("s", "x_att", "x_ffn"):
            assert ts[key].dtype == torch.float32
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} step {t}")
        np.testing.assert_array_equal(ts["length"].numpy(), np.asarray(js["length"]))


def test_bf16_state_stays_f32_and_tracks_jax():
    """In bfloat16 the state leaves stay f32 (the reference's chain) and
    the step's logits agree with the JAX step's at bf16 rounding."""
    jm, jparams, tm, tparams = _models("bfloat16")
    b = 2
    js, ts = jm.init_decode_state(b, 16), tm.init_decode_state(b, 16)
    rng = np.random.default_rng(2)
    step = jax.jit(jm.serve_step)
    for _ in range(4):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, ts = tm.serve_step(tparams, ts, torch.from_numpy(tok))
    assert {k: str(v.dtype).split(".")[-1] for k, v in ts.items()} == \
        {k: str(v.dtype) for k, v in js.items()}
    w = np.asarray(jl)
    assert np.abs(tl.numpy() - w).max() <= 2 ** -4 * np.abs(w).max()
