"""Training on a ("data", "model") mesh against the JAX package's mesh
train step.

llama3.2-1b's and moonshot-v1-16b-a3b's smoke configs take two steps on
a port (2, 2) mesh of 4 gloo ranks on the CPU (`_sp_rank.py train`:
`shardings_for`, `adamw.init(mesh=)` with ZeRO-1 moments,
`make_train_step(model, ocfg, mesh, rules)`), against
`jax.jit(make_train_step(model, ocfg, mesh, rules))` placed by the
reference's `shardings_for` on 4 forced host devices
(`_mesh_train_jax.py`), from `init_params(PRNGKey(0))` and the data
pipeline's batches. Held, at the training tests' tolerances: the loss within 1e-5
relative; every gradient leaf (the ranks' blocks joined by
`unshard_tree`) within 1e-4 relative L2; the parameters and moments
after each step within 1e-4 relative L2; the gradient norm. The second
step starts from each side's own first step, so its gradients carry the
first step's rounding through Adam's sign-like first update. On a mesh
the MoE is the capacity dispatch, not the one-device dense fallback:
moonshot's mesh loss is not its one-device loss, and its drop count is
JAX's. ZeRO-1 on and off give the same bits, and llama's mesh loss is
the port's one-device loss.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from _sp_common import flatten, run_jax_and_ranks

from repro.configs.registry import get_config as jget_config
from repro.models.api import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.models.api import build_model
from repro_torch.parallel.sharding import AbstractMesh, make_rules
from repro_torch.tree import flatten_with_paths

CASES = {"llama": "llama3.2-1b", "moonshot": "moonshot-v1-16b-a3b"}
STEPS = 2
B, S = 4, 16
LOSS_RTOL = 1e-5
TOL = 1e-4
MESH = AbstractMesh((2, 2), ("data", "model"))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    """The smoke config's `init_params(PRNGKey(0))` as numpy."""
    jm = jbuild(jget_config(arch, smoke=True))
    return jax.tree.map(np.asarray, jax.jit(jm.init_params)(
        jax.random.PRNGKey(0)))


def train_inputs(c, arch, steps, *, mesh="2x2", seed=0):
    """Case c's inputs: the parameters and steps + 1 batches (the data
    pipeline's, frames for the audio family)."""
    cfg = get_config(arch, smoke=True)
    out = {f"{c}/arch": np.asarray(arch), f"{c}/mesh": np.asarray(mesh),
           f"{c}/steps": np.asarray(steps)}
    out.update(flatten(jax_params(arch), f"{c}/params/"))
    for i in range(steps + 1):
        b = batch_for_step(i, vocab=cfg.vocab, batch=B, seq=S, seed=seed,
                           family=cfg.family, cfg=cfg)
        out.update({f"{c}/batch{i}/{k}": v for k, v in b.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    inp = {"train_cases": np.asarray(list(CASES))}
    for c, arch in CASES.items():
        inp.update(train_inputs(c, arch, STEPS))
    inp["llama/zero1_ab"] = np.asarray(1)
    inp["moonshot/drops"] = np.asarray(1)
    np.savez(tmp / "inputs.npz", **inp)
    jax_out, ranks = run_jax_and_ranks(open("tests/_mesh_train_jax.py").read(),
                                       "train", 4, tmp)
    return inp, jax_out, ranks


def _close(got, want, what, tol=TOL):
    """Within tol relative L2 of want (the training tests' measure of a
    leaf, `_train_common`)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel <= tol, (what, rel)


def joined(ranks, c, model, get, mesh=MESH, specs=None):
    """The logical tree of a per-rank tree `get(rank result)`."""
    rules = make_rules(mesh)
    specs = specs if specs is not None else model.param_specs(rules)
    return bridge.unshard_tree([get(r[c]) for r in ranks], specs, mesh)


def assert_tree_close(tree, jax_out, prefix, what):
    for path, got in flatten_with_paths(tree):
        key = prefix + path[2:-2].replace("']['", "/")
        _close(got.numpy(), jax_out[key], (what, path))


def assert_grads_match(jax_out, ranks, c, arch, steps):
    """Loss and every gradient leaf at each step's start."""
    model = build_model(get_config(arch, smoke=True), device="cpu")
    for i in range(steps + 1):
        want = float(jax_out[f"{c}/{i}/loss"])
        for r in ranks:
            got = float(r[c]["steps"][i]["loss"])
            assert abs(got - want) <= LOSS_RTOL * abs(want), (c, i, got, want)
        grads = joined(ranks, c, model, lambda x: x["steps"][i]["grads"])
        assert_tree_close(grads, jax_out, f"{c}/{i}/grads/", (c, i, "grad"))


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_loss_and_grads_match_jax_mesh_step(runs, c):
    _, jax_out, ranks = runs
    assert_grads_match(jax_out, ranks, c, CASES[c], STEPS)


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_steps_match_jax_mesh_steps(runs, c):
    """Parameters, ZeRO-1 moments and metrics after each step."""
    from repro_torch.launch.train import shardings_for
    _, jax_out, ranks = runs
    model = build_model(get_config(CASES[c], smoke=True), device="cpu")
    full = bridge.params_from_numpy(jax_params(CASES[c]))
    pspecs, ospecs = shardings_for(model, MESH, make_rules(MESH), full)
    for i in range(STEPS):
        for r in ranks:
            got = r[c]["steps"][i]
            assert abs(float(got["step_loss"]) - float(jax_out[f"{c}/{i}/step_loss"])) \
                <= LOSS_RTOL * abs(float(jax_out[f"{c}/{i}/step_loss"]))
            _close(float(got["grad_norm"]), jax_out[f"{c}/{i}/grad_norm"],
                   (c, i, "grad_norm"))
        assert_tree_close(joined(ranks, c, model, lambda x: x["steps"][i]["params"]),
                          jax_out, f"{c}/{i}/params/", (c, i, "params"))
        for name in ("m", "v"):
            tree = joined(ranks, c, model, lambda x: x["steps"][i][name],
                          specs=ospecs.m)
            assert_tree_close(tree, jax_out, f"{c}/{i}/{name}/", (c, i, name))


def test_zero1_moments_are_slices_and_bit_equal_to_replicated(runs):
    """ZeRO-1: every moment block is the rank's data-slice of its
    parameter block where zero1_specs says so (half the elements on 2
    data ranks), and the parameters after each step equal, bit for bit,
    those of the run with moments placed as their parameters. The norm
    is JAX's (a norm counting a replicated leaf twice would move the
    clip scale and both runs with it)."""
    _, jax_out, ranks = runs
    for r in ranks:
        res = r["llama"]
        emb = res["moment_shapes"]["embed"]
        assert emb == (512 // 2, 128 // 2), emb
        for i in range(STEPS):
            a, b = res["steps"][i], res["replicated"][i]
            assert torch.equal(a["grad_norm"], b["grad_norm"])
            for (p, x), (_, y) in zip(flatten_with_paths(a["params"]),
                                      flatten_with_paths(b["params"])):
                assert torch.equal(x, y), (i, p)
            _close(float(a["grad_norm"]), jax_out[f"llama/{i}/grad_norm"],
                   (i, "grad_norm"), tol=1e-5)


def test_moe_mesh_step_drops_as_jax(runs):
    _, jax_out, ranks = runs
    drops = sum(r["moonshot"]["drops"] for r in ranks)
    assert drops == int(jax_out["moonshot/drops"]) > 0, drops


def test_llama_mesh_loss_is_the_one_device_loss(runs):
    """Dense TP changes only the sum orders; the MoE's capacity dispatch
    changes the function, so moonshot's mesh loss
    leaves its one-device loss."""
    inp, _, ranks = runs
    from repro_torch.launch.train import batch_to
    for c, arch in CASES.items():
        model = build_model(get_config(arch, smoke=True), device="cpu")
        params = bridge.params_from_numpy(jax_params(arch))
        batch = batch_to({k: inp[f"{c}/batch0/{k}"] for k in ("tokens", "targets")},
                         "cpu")
        with torch.no_grad():
            one = float(model.loss_fn(params, batch))
        mesh_loss = float(ranks[0][c]["steps"][0]["loss"])
        if c == "llama":
            assert abs(mesh_loss - one) <= LOSS_RTOL * abs(one), (mesh_loss, one)
        else:
            assert abs(mesh_loss - one) > 1e-4 * abs(one), (mesh_loss, one)


def test_mesh_train_bill(runs):
    """The collectives a step bills: the data-axis gradient sum, the
    loss's global mask sum and ZeRO-1's parameter gather on "data"; the
    vocab-parallel loss, the TP psums and their backward, and the norm of
    the leaves sharded over it on "model"."""
    _, _, ranks = runs
    bill = ranks[0]["llama"]["bill"]
    assert {"grad", "ce_mask", "loss", "zero1"} <= set(bill["data"]), bill
    assert {"ce_max", "ce_sum", "ce_gold", "embed", "wo", "ffn",
            "wq_grad", "norm"} <= set(bill["model"]), bill
    # no parameter is sharded over "data": no norm psum there
    assert "norm" not in bill["data"], bill
    moe = ranks[0]["moonshot"]["bill"]["model"]
    assert {"ep_dispatch", "ep_return", "ep_tokens", "ep_dispatch_grad",
            "ep_router_grad"} <= set(moe), moe


UPDATE_TAGS = {"norm", "zero1"}     # adamw.update's; the rest loss_and_grads'


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_train_shadow_bill_equals_live(runs, c):
    """The dry run's shadow train step (`launch.dryrun.shadow_step`: rank
    0's ZeRO-1 step on the meta device under a `ShadowMesh`) at this
    file's mesh, config and batch bills what rank 0 billed: its run is
    STEPS + 1 `loss_and_grads` and STEPS steps, each a `loss_and_grads`
    and an `adamw.update`, so every tag of the update is billed STEPS
    times the shadow's and every other 2 STEPS + 1 times, calls and
    bytes."""
    from repro_torch.launch import dryrun
    _, _, ranks = runs
    model = build_model(get_config(CASES[c], smoke=True), device="meta")
    cell = {"kind": "train", "seq_len": S, "global_batch": B}
    shadow = dryrun.shadow_step(model, cell, MESH, make_rules(MESH))["bill"]
    live = ranks[0][c]["bill"]
    assert set(shadow) == set(live)
    for axis, tags in live.items():
        assert set(tags) == set(shadow[axis]), axis
        for tag, got in tags.items():
            n = STEPS if tag in UPDATE_TAGS else 2 * STEPS + 1
            want = {k: n * v for k, v in shadow[axis][tag].items()}
            assert got == want, (axis, tag)
