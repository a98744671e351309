"""The port's training path against the JAX package: the dense, MoE and
vlm families' loss and gradients, the blockwise causal attention alone,
AdamW, the train step over 8 steps, checkpoint/resume (bit for bit, and
across the two packages), the data pipeline, fault tolerance and the
train CLI. The enc-dec, ssm and hybrid families are in
`test_torch_train_families.py`; the 8-step runs of the dense and MoE
families in `test_torch_train_steps.py`, the resume and the CLI in
`test_torch_train_resume.py` (moved there so that no test file runs past
the tier-1 budget).

Parameters come from the JAX package's `init_params` of each smoke
config (float32), carried over by `repro_torch.bridge`; batches from
numpy with fixed seeds. Tolerances (`_train_common`): loss within 1e-5
relative, each gradient leaf within 1e-4 relative L2, the indexer's
leaves exactly zero in both; the attention alone within 1e-5 (output) and
1e-4 (gradients) relative L2; one AdamW update within 1e-6 relative L2 in
parameters and moments, grad_norm and lr within one float32 ulp; 8
training steps from the reference's init and batch: the port's own run's
losses within 1e-4 relative (1e-6 absolute near zero, below float32's
resolution of the logits) of JAX's, falling, and each step taken from
JAX's state within 1e-5 of JAX's loss and 1e-4 of its next parameters
and moments.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.launch.train import make_train_step as jax_train_step
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import batch_for_step, synthetic_stream
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.tree import flatten_with_paths, leaves, tree_map, unflatten

from _train_common import (assert_loss_grads_match, one_thread,  # noqa: F401
                           setup, state_to_port)

pytestmark = pytest.mark.usefixtures("one_thread")

RNG = np.random.default_rng(24)

TRANSFORMER_ARCHS = ["llama3.2-1b", "h2o-danube-3-4b", "chatglm3-6b",
                     "granite-34b", "qwen2-vl-7b", "granite-moe-1b-a400m",
                     "moonshot-v1-16b-a3b"]


# ------------------------------ loss and gradients -------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """jax.value_and_grad of the JAX loss_fn against the port's autograd,
    leaf by leaf, with remat on (the train step's path) and off. B = 2,
    S = 128 for h2o-danube (its smoke window is 64, so the SWA mask cuts
    rows), S = 32 otherwise; qwen2-vl with patch embeddings, so
    `patch_proj` gets a gradient."""
    s = 128 if arch == "h2o-danube-3-4b" else 32
    assert_loss_grads_match(arch, 2, s, seed=5, remat=remat)


@pytest.mark.parametrize("window", [None, 700])
def test_blockwise_causal_attention_matches_jax(window):
    """The attention alone at S = 2048 (4 query blocks of 512, 2 key
    blocks of 1024; GQA 4 heads over 2): output and the gradients of
    sum(out * cotangent) in q, k and v. Under a window of 700 the rows
    past 1723 see nothing in key block 0: its p = 1 rows are wiped by
    block 1's alpha = 0."""
    b, s, h, kvh, d = 1, 2048, 4, 2, 16
    q, k, v = (RNG.standard_normal((b, s, n, d)).astype(np.float32)
               for n in (h, kvh, kvh))
    ct = RNG.standard_normal((b, s, h, d)).astype(np.float32)

    def jfn(q, k, v):
        return jlayers.blockwise_causal_attention(q, k, v, scale=d ** -0.5,
                                                  window=window)

    jout, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(ct))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = layers.blockwise_causal_attention(tq, tk, tv, scale=d ** -0.5,
                                            window=window)
    assert out.dtype == torch.float32 and out.shape == (b, s, h, d)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))

    def rel(got, want):
        want = np.asarray(want)
        return np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)

    assert rel(out, jout) <= 1e-5
    for name, g, w in zip("qkv", grads, jgrads):
        assert rel(g, w) <= 1e-4, name


def test_blockwise_attention_rejects_ragged_blocks():
    x = torch.zeros((1, 600, 2, 8))
    with pytest.raises(AssertionError):
        layers.blockwise_causal_attention(x, x, x, scale=1.0)


def test_masked_loss_matches_jax():
    """loss_fn with a mask (half the positions): JAX divides by
    max(sum(mask), 1) too; an all-zero mask gives 0."""
    jm, jparams, nparams, tm = setup("llama3.2-1b")
    batch = {"tokens": RNG.integers(0, 512, (2, 32)).astype(np.int32),
             "targets": RNG.integers(0, 512, (2, 32)).astype(np.int32)}
    params = bridge.params_from_numpy(nparams)
    for mask in (RNG.integers(0, 2, (2, 32)).astype(np.float32),
                 np.zeros((2, 32), np.float32)):
        b = dict(batch, mask=mask)
        want = float(jm.loss_fn(jparams, {k: jnp.asarray(x) for k, x in b.items()}))
        got = float(tm.loss_fn(params, {k: torch.from_numpy(x)
                                        for k, x in b.items()}))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), (got, want)


def test_loss_gradient_at_large_logits_matches_jax():
    """The loss's gradient in the logits where they are ~100 in size and
    the loss has fallen to ~1e-2 (a gold margin of 12): the reference's
    logsumexp - gold tail under jax.grad against `layers.cross_entropy`,
    within the gradient tolerance (1e-4 relative L2). A logsumexp whose
    backward divides by exp(result) (torch.logsumexp) carries an ulp of
    ~100 into p - onehot and lands 2.2e-4 apart here."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 16, 512)) + 100).astype(np.float32)
    targets = rng.integers(0, 512, (2, 16)).astype(np.int32)
    np.put_along_axis(logits, targets[..., None], np.take_along_axis(
        logits, targets[..., None], -1) + 12, -1)

    def tail(x):
        logz = jax.scipy.special.logsumexp(x, axis=-1)
        gold = jnp.take_along_axis(x, jnp.asarray(targets)[..., None],
                                   axis=-1)[..., 0]
        return jnp.mean(logz - gold)

    want = np.asarray(jax.grad(tail)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got, = torch.autograd.grad(layers.cross_entropy(
        x, {"targets": torch.from_numpy(targets)}), x)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


def test_backward_matches_jax_from_the_same_loss_gradient_when_saturated():
    """Where the loss has fallen near 0 (llama's smoke tree after 3 of the
    JAX package's train steps on the rolled batch at B = 2, S = 16: loss
    2.7e-4), `wq`'s and `wk`'s gradients are ~1e-3 of the other leaves'
    and ill-conditioned: the last digits of the loss's gradient in the
    logits (a summation order) move them ~1e-2. Fed the same gradient in
    the logits (the port's), JAX's backward (`jax.vjp` of
    `forward_train`) and the port's agree on every leaf within 1e-5
    relative L2, so that gap is the loss tail's rounding, not the
    backward."""
    jm, jparams, _, tm = setup("llama3.2-1b")
    tok = np.stack([np.roll(np.arange(16) % 97, r)
                    for r in range(2)]).astype(np.int32)
    targets = np.roll(tok, -1, axis=1)
    jb = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(targets)}
    jstep = jax.jit(jax_train_step(jm, jadamw.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=100)))
    jopt = jadamw.init(jparams)
    for _ in range(3):
        jparams, jopt, _ = jstep(jparams, jopt, jb)
    params, _ = state_to_port(jparams, jopt)
    live = [p.detach().requires_grad_() for p in leaves(params)]
    logits = tm.forward_train(unflatten(params, live), torch.from_numpy(tok))
    x = logits.detach().requires_grad_()
    loss = layers.cross_entropy(x, {"targets": torch.from_numpy(targets)})
    assert float(loss.detach()) < 1e-3, float(loss.detach())
    dlogits, = torch.autograd.grad(loss, x)
    got = torch.autograd.grad(logits, live, dlogits, allow_unused=True)
    _, vjp = jax.vjp(lambda p: jm.forward_train(p, jb["tokens"]), jparams)
    want, = vjp(jnp.asarray(dlogits.numpy()))
    want = {jax.tree_util.keystr(k): np.asarray(a) for k, a in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    for (path, _), g in zip(flatten_with_paths(params), got):
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 1e-5, (path, rel)


# ------------------------------ AdamW -------------------------------------

def _ulp_close(got, want):
    want = np.float32(want)
    return abs(np.float32(got) - want) <= np.spacing(abs(want))


@pytest.mark.parametrize("count,ocfg", [
    (0, dict()),                                        # warm-up, clipped
    (150, dict(total_steps=1000, clip_norm=1e6)),       # cosine, not clipped
    (2000, dict(total_steps=1000, weight_decay=0.3)),   # past the schedule
])
def test_adamw_update_matches_jax(count, ocfg):
    """One update of llama's smoke tree from the same gradients and a
    state with random moments: parameters and moments within 1e-6
    relative L2, grad_norm and lr within one ulp, count + 1. The indexer
    leaves, zero gradient and zero moments as training leaves them, decay
    alone, p - lr * (wd * p) bit for bit, and as in JAX."""
    cfg = jadamw.AdamWConfig(**ocfg)
    _, _, nparams, _ = setup("llama3.2-1b")
    rng = np.random.default_rng(count)

    def rand(scale, positive=False):
        def one(a):
            if positive:
                return np.abs(rng.normal(0, scale, a.shape)).astype(np.float32)
            return rng.normal(0, scale, a.shape).astype(np.float32)
        return jax.tree.map(one, nparams)

    grads, m, v = rand(0.5), rand(0.1), rand(0.01, positive=True)
    for tree in (grads, m, v):     # the indexer as the train step leaves it
        tree["layers"]["indexer"] = jax.tree.map(np.zeros_like,
                                                 tree["layers"]["indexer"])
    jstate = jadamw.OptState(jax.tree.map(jnp.asarray, m),
                             jax.tree.map(jnp.asarray, v), jnp.int32(count))
    jp, js, jmet = jadamw.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jax.tree.map(jnp.asarray, nparams), cfg)
    tparams = bridge.params_from_numpy(nparams)
    before = {p: t.clone() for p, t in flatten_with_paths(tparams)}
    tstate = adamw.OptState(bridge.params_from_numpy(m),
                            bridge.params_from_numpy(v),
                            torch.tensor(count, dtype=torch.int32))
    tp, ts, tmet = adamw.update(bridge.params_from_numpy(grads), tstate,
                                tparams, adamw.AdamWConfig(**ocfg))
    assert _ulp_close(float(tmet["grad_norm"]), float(jmet["grad_norm"]))
    assert _ulp_close(float(tmet["lr"]), float(jmet["lr"]))
    assert int(ts.count) == int(js.count) == count + 1
    assert ts.count.dtype == torch.int32
    for got_tree, want_tree in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
        want = {jax.tree_util.keystr(k): np.asarray(a) for k, a in want.items()}
        for path, got in flatten_with_paths(got_tree):
            w = want[path]
            rel = np.linalg.norm(got.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= 1e-6, (path, rel)
    lr, wd = tmet["lr"], cfg.weight_decay
    for path, got in flatten_with_paths(tp):
        if "['indexer']" in path:
            p0 = before[path]
            assert torch.equal(got, (p0.float() - lr * (wd * p0.float())).to(p0.dtype))


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0)
    for _ in range(100):
        g = {"w": 2 * params["w"]}
        params, opt, _ = adamw.update(g, opt, params, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1e-3, warmup_steps=1,
                            weight_decay=0.0)
    g = {"w": torch.tensor([1e9, -1e9, 1e9])}
    _, _, m = adamw.update(g, opt, params, cfg)
    assert float(m["grad_norm"]) > 1e8   # raw norm reported pre-clip


# ------------------------------ the train step ----------------------------


def _trained_state(seed):
    """llama smoke's parameters and an OptState with random moments."""
    _, jparams, nparams, _ = setup("llama3.2-1b")
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), nparams)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), nparams)
    return nparams, m, v


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A float32 (params, OptState) checkpoint written by the JAX package
    restores into the port with equal values, and the port's into the
    JAX package; both write the same manifest (paths and hash)."""
    nparams, m, v = _trained_state(3)
    jtree = (jax.tree.map(jnp.asarray, nparams),
             jadamw.OptState(jax.tree.map(jnp.asarray, m),
                             jax.tree.map(jnp.asarray, v), jnp.int32(7)))
    ttree = (bridge.params_from_numpy(nparams),
             adamw.OptState(bridge.params_from_numpy(m),
                            bridge.params_from_numpy(v),
                            torch.tensor(7, dtype=torch.int32)))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), jtree, 7)
    ckpt.save(str(tdir), ttree, 7)
    jman = (jdir / "step_7" / "manifest.json").read_text()
    assert (tdir / "step_7" / "manifest.json").read_text() == jman
    like = tree_map(torch.zeros_like, ttree)
    got, step = ckpt.restore_latest(str(jdir), like)
    assert step == 7 and isinstance(got[1], adamw.OptState)
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    back, step = jckpt.restore_latest(str(tdir), jax.tree.map(jnp.zeros_like,
                                                              jtree))
    assert step == 7
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, jtree)


def test_bf16_checkpoint_roundtrip_and_device(tmp_path):
    """bfloat16 leaves come back bit for bit (stored as the reference
    stores them); a float32 file restores into a bf16 tree by rounding;
    `device` places the leaves."""
    t = {"w": torch.randn(4, 8).to(torch.bfloat16),
         "n": torch.arange(5, dtype=torch.int32)}
    ckpt.save(str(tmp_path), t, 1)
    out = ckpt.restore(str(tmp_path), 1, tree_map(torch.zeros_like, t),
                       device="cpu")
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], t["w"])
    assert torch.equal(out["n"], t["n"])
    f = {"w": torch.randn(4, 8), "n": t["n"]}
    ckpt.save(str(tmp_path), f, 2)
    out = ckpt.restore(str(tmp_path), 2, t)
    assert torch.equal(out["w"], f["w"].to(torch.bfloat16))


# ------------------------------ checkpoint (the reference's cases) --------

def _tree():
    return {"w": torch.from_numpy(RNG.normal(size=(4, 8)).astype(np.float32)),
            "b": {"x": torch.arange(5, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), t, 7)
    out, step = ckpt.restore_latest(str(tmp_path), t)
    assert step == 7
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b), t, out)


def test_checkpoint_latest_and_retention(tmp_path):
    t = _tree()
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(str(tmp_path), t, s, keep_last=2)
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]


def test_checkpoint_atomicity_tmp_never_restored(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), t, 1)
    os.makedirs(tmp_path / "step_2.tmp")      # a crash mid-write
    _, step = ckpt.restore_latest(str(tmp_path), t)
    assert step == 1


def test_checkpoint_structure_validation(tmp_path):
    ckpt.save(str(tmp_path), _tree(), 1)
    bad = {"w": torch.zeros((4, 8)), "b": {"y": torch.zeros(5)}}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, bad)


def test_checkpoint_async_copies_before_returning(tmp_path):
    """save(block=False) writes on a thread; the tensors were copied to
    host memory first, so an in-place update after the call is not
    saved."""
    t = _tree()
    want = t["w"].clone()
    th = ckpt.save(str(tmp_path), t, 3, block=False)
    t["w"].add_(1.0)
    th.join()
    assert ckpt.all_steps(str(tmp_path)) == [3]
    out = ckpt.restore(str(tmp_path), 3, t)
    assert torch.equal(out["w"], want)


# ------------------------------ data --------------------------------------

@pytest.mark.parametrize("arch,step,host,hosts", [
    ("llama3.2-1b", 0, 0, 1), ("llama3.2-1b", 11, 1, 4),
    ("whisper-medium", 3, 0, 2), ("qwen2-vl-7b", 5, 1, 2)])
def test_batch_for_step_equals_the_reference(arch, step, host, hosts):
    """Every array of batch_for_step (frames for audio, patch_embeds for
    the vlm) equal to the JAX package's, bit for bit."""
    cfg = setup(arch)[3].cfg
    kw = dict(vocab=cfg.vocab, batch=4, seq=16, seed=2, host_id=host,
              num_hosts=hosts, family=cfg.family, cfg=cfg)
    got, want = batch_for_step(step, **kw), jpipe.batch_for_step(step, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_stream_equals_the_reference():
    kw = dict(vocab=100, batch=2, seq=8, seed=4)
    a, b = synthetic_stream(**kw), jpipe.synthetic_stream(**kw)
    for _ in range(3):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])


def test_data_determinism_across_restart():
    a = batch_for_step(11, vocab=1000, batch=8, seq=16, seed=5)
    b = batch_for_step(11, vocab=1000, batch=8, seq=16, seed=5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_data_elastic_resharding_preserves_global_stream():
    g4 = np.concatenate([batch_for_step(3, vocab=50, batch=8, seq=4, seed=0,
                                        host_id=h, num_hosts=4)["tokens"]
                         for h in range(4)])
    g2 = np.concatenate([batch_for_step(3, vocab=50, batch=8, seq=4, seed=0,
                                        host_id=h, num_hosts=2)["tokens"]
                         for h in range(2)])
    np.testing.assert_array_equal(g4, g2)


def test_targets_are_shifted_tokens():
    b = batch_for_step(0, vocab=50, batch=2, seq=8, seed=0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


# --------------------------- fault tolerance ------------------------------

def test_resilient_step_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    wrapped = ft.resilient_step(flaky, max_retries=3, backoff_s=0.0)
    assert wrapped(10, 5) == "ok"
    assert calls["n"] == 3


def test_resilient_step_raises_stepfailed_with_rollback_info():
    def always_fails():
        raise RuntimeError("hard fault")

    wrapped = ft.resilient_step(always_fails, max_retries=1, backoff_s=0.0)
    with pytest.raises(ft.StepFailed) as ei:
        wrapped(42, 40)
    assert ei.value.last_good_step == 40


def test_elastic_plan_rebalance():
    plan = ft.ElasticPlan(alive_hosts=list(range(8)), global_batch=64)
    plan2 = plan.rebalanced(lost=[3])
    assert len(plan2.alive_hosts) in (4, 7)   # divisor of 64
    assert 3 not in plan2.alive_hosts
    rank, n = plan2.shard_for(plan2.alive_hosts[-1])
    assert 0 <= rank < n


def test_shard_owner_deterministic_and_covering():
    alive = [0, 2, 5]
    owners = {ft.shard_owner(7, s, alive) for s in range(30)}
    assert owners <= set(alive)
    assert ft.shard_owner(7, 3, alive) == ft.shard_owner(7, 3, alive)


def test_straggler_monitor_flags_outliers():
    mon = ft.StragglerMonitor(threshold=2.0, warmup=3)
    for i in range(10):
        assert not mon.record(i, 1.0)
    assert mon.record(10, 5.0)
    assert 10 in mon.flagged


def test_adamw_cpu_slices_give_the_same_bits(monkeypatch):
    """On the CPU a leaf is updated in slices (of 2^22 elements): slices
    of 1000 and whole leaves (the card's span) give every parameter and
    moment bit for bit alike."""
    _, _, nparams, _ = setup("llama3.2-1b")
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         nparams)
    outs = []
    for span in (adamw._CPU_SLICE, 1000, 1 << 40):
        monkeypatch.setattr(adamw, "_CPU_SLICE", span)
        params = bridge.params_from_numpy(nparams)
        outs.append(adamw.update(bridge.params_from_numpy(grads),
                                 adamw.init(params), params,
                                 adamw.AdamWConfig(warmup_steps=1)))
    (pa, oa, _), *rest = outs
    for pb, ob, _ in rest:
        for (path, a), (_, b) in zip(flatten_with_paths((pa, oa)),
                                     flatten_with_paths((pb, ob))):
            assert torch.equal(a, b), path
