"""Shared pieces of the training parity tests (`test_torch_train*.py`):
one parameter tree from the JAX package's init for both packages, numpy
batches, the JAX loss and gradients (jitted `jax.value_and_grad` of the
model's `loss_fn`) and the port's (autograd, with and without remat),
and the comparison the tests state.

Tolerances (float32 smoke configs on the CPU, products and reductions in
other orders): loss |delta| <= 1e-5 |loss|; every gradient leaf within
1e-4 relative L2 of JAX's; the DSA indexer's leaves exactly zero in both
(the loss does not reach them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.launch.train import make_train_step as jax_train_step
from repro.models.api import build_model as jax_build
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import loss_and_grads, make_train_step
from repro_torch.models.api import build_model
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, leaves, unflatten

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for the port's steps while a module runs: at
    smoke sizes more threads gain nothing, and under the test workers
    they oversubscribe the cores (six such processes at the default
    eight threads each ran the jamba case ~20x slower than one does
    alone; at one thread each, 1.5x)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed(tree, seed):
    """The numpy tree with every constant leaf (norm scales, RWKV mixes,
    decays and bonus, Mamba biases and skips) moved by N(0, 0.1) noise,
    so that no term of the loss is degenerate at init."""
    rng = np.random.default_rng(seed)

    def move(a):
        if a.dtype.kind != "f" or a.std() > 0:
            return a
        return (a + rng.normal(0, 0.1, a.shape)).astype(a.dtype)

    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def setup(arch, seed=1):
    """(JAX model, JAX params, numpy params, port model on the CPU) of the
    arch's smoke config, from `init_params(PRNGKey(seed))` perturbed."""
    jm = jax_build(jax_config(arch, smoke=True))
    nparams = perturbed(jax.tree.map(np.asarray,
                                     jm.init_params(jax.random.PRNGKey(seed))),
                        seed)
    return (jm, jax.tree.map(jnp.asarray, nparams), nparams,
            build_model(get_config(arch, smoke=True), device="cpu"))


def np_batch(cfg, b, s, seed):
    """Random tokens and targets, with frames (audio) and patch
    embeddings (vlm) as the data pipeline makes them, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def jax_loss_grads(arch, b, s, seed):
    """JAX's loss and gradient leaves (keystr path, array) of the batch."""
    jm, jparams, _, tm = setup(arch)
    batch = np_batch(tm.cfg, b, s, seed)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(loss), [(jax.tree_util.keystr(p), np.asarray(g))
                         for p, g in flat]


def port_loss_grads(arch, b, s, seed, remat):
    """The port's loss and gradient leaves of the same batch: through
    `launch.train.loss_and_grads` (the train step's, remat on), or the
    forward with remat off under autograd."""
    _, _, nparams, tm = setup(arch)
    params = bridge.params_from_numpy(nparams)
    batch = {k: torch.from_numpy(v) for k, v in
             np_batch(tm.cfg, b, s, seed).items()}
    if remat:
        loss, grads = loss_and_grads(tm, params, batch)
    else:
        live = [p.detach().requires_grad_() for p in leaves(params)]
        kw = {k: batch[k] for k in ("frames", "patch_embeds") if k in batch}
        loss = cross_entropy(tm.forward_train(unflatten(params, live),
                                              batch["tokens"], remat=False,
                                              **kw), batch)
        got = torch.autograd.grad(loss, live, allow_unused=True)
        grads = unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for g, p in zip(got, live)])
    return float(loss.detach()), [(p, g.detach().numpy())
                                  for p, g in flatten_with_paths(grads)]


def assert_loss_grads_match(arch, b, s, seed, remat):
    """The port's loss and every gradient leaf against JAX's at the
    stated tolerances; the indexer leaves exactly zero in both. Returns
    the worst leaf's relative L2."""
    jloss, jgrads = jax_loss_grads(arch, b, s, seed)
    tloss, tgrads = port_loss_grads(arch, b, s, seed, remat)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    assert [p for p, _ in tgrads] == [p for p, _ in jgrads]
    worst = 0.0
    for (path, g), (_, w) in zip(tgrads, jgrads):
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), path
        if "['indexer']" in path:
            assert not g.any() and not w.any(), path
            continue
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_RTOL, (path, rel)
        worst = max(worst, rel)
    return worst


@functools.lru_cache(maxsize=None)
def reference_setup(arch):
    """(JAX model, JAX params, port model on the CPU) as the JAX
    package's `test_arch_loss_decreases` takes them: the smoke config's
    `init_params(PRNGKey(1))`, not perturbed."""
    jm = jax_build(jax_config(arch, smoke=True))
    return (jm, jm.init_params(jax.random.PRNGKey(1)),
            build_model(get_config(arch, smoke=True), device="cpu"))


def _rolled_batch(cfg, b=4, s=32):
    """The JAX package's `test_arch_loss_decreases` batch: rolled aranges,
    targets shifted by one, (4, 32)."""
    tok = np.stack([np.roll(np.arange(s) % min(cfg.vocab, 97), r)
                    for r in range(b)]).astype(np.int32)
    return {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}


def state_to_port(jparams, jopt):
    """JAX's (params, OptState) as the port's, leaf for leaf."""
    np_tree = lambda t: bridge.params_from_numpy(jax.tree.map(np.asarray, t))
    return np_tree(jparams), adamw.OptState(
        np_tree(jopt.m), np_tree(jopt.v),
        torch.tensor(int(jopt.count), dtype=torch.int32))


def _worst_state(port, jax_state):
    """The worst leaf's relative L2 over (params, m, v), port vs JAX."""
    (tp, to), (jp, jo) = port, jax_state
    worst = (0.0, "")
    for got_tree, want_tree, name in ((tp, jp, "params"), (to.m, jo.m, "m"),
                                      (to.v, jo.v, "v")):
        want = {jax.tree_util.keystr(k): np.asarray(a) for k, a in
                jax.tree_util.tree_flatten_with_path(want_tree)[0]}
        for path, got in flatten_with_paths(got_tree):
            w = want[path]
            rel = np.linalg.norm(got.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            worst = max(worst, (float(rel), name + path))
    return worst


TRAIN_LOSS_RTOL = 1e-4     # free-running losses, step by step
TRAIN_LOSS_ATOL = 1e-6     # below float32's resolution of the logits
STEP_LOSS_RTOL = 1e-5      # a step taken from JAX's state
STEP_STATE_RTOL = GRAD_RTOL  # its (params, m, v) against JAX's next state:
# each is a function of gradients held at GRAD_RTOL; a zero-init leaf
# after one step is Adam's sign-like step alone (jamba's Mamba `conv_b`
# lands 1.7e-5 apart)


def assert_train_steps_match_jax(arch, steps=8):
    """The JAX package's `test_arch_loss_decreases` in both packages: 8
    train steps (AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)) on
    its batch from its init.

    Free-running, the port's own chain of `make_train_step` calls: its
    losses fall and stay within 1e-4 relative of JAX's step by step, or
    1e-6 absolute once a loss has fallen below what float32 resolves (it
    is logsumexp minus the gold logit, two numbers of the logits' size:
    ~90 in llama's smoke init, whose float32 spacing is 7.6e-6).

    Each step also taken from JAX's state after the step before: its
    loss within 1e-5 relative (1e-6 absolute) of JAX's, and the
    parameters and moments it writes within 1e-4 relative L2 (the
    gradients' tolerance) of JAX's next state, leaf by leaf."""
    jm, jparams, tm = reference_setup(arch)
    batch = _rolled_batch(tm.cfg)
    ocfg = dict(lr=3e-3, warmup_steps=1, total_steps=100)
    jstep = jax.jit(jax_train_step(jm, jadamw.AdamWConfig(**ocfg)))
    tstep = make_train_step(tm, adamw.AdamWConfig(**ocfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jopt = jadamw.init(jparams)
    tparams, topt = state_to_port(jparams, jopt)
    free, forced, jl = [], [], []
    for i in range(steps):
        fparams, fopt, fmet = tstep(*state_to_port(jparams, jopt), batch)
        jparams, jopt, jmet = jstep(jparams, jopt, jb)
        tparams, topt, tmet = tstep(tparams, topt, batch)
        jl.append(float(jmet["loss"]))
        forced.append(float(fmet["loss"]))
        free.append(float(tmet["loss"]))
        worst = _worst_state((fparams, fopt), (jparams, jopt))
        assert worst[0] <= STEP_STATE_RTOL, (i, worst)
    assert free[-1] < free[0], free
    np.testing.assert_allclose(forced, jl, rtol=STEP_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL)
    np.testing.assert_allclose(free, jl, rtol=TRAIN_LOSS_RTOL,
                               atol=TRAIN_LOSS_ATOL)
