"""The port's side of the mesh training tests: tasks of `_sp_rank.py`
(one process a rank, 4 gloo ranks on the CPU), imported by it.

* "train": each case of inputs.npz (a smoke config, its parameters and
  batches, a mesh "DxM", a number of steps) on its mesh: the loss and the
  rank's gradient blocks at each step's start (`loss_and_grads`), then
  `make_train_step` with ZeRO-1 moments (`shardings_for`): the rank's
  blocks of the parameters and moments after each step and the metrics.
  With "zero1_ab", the same steps again with the moments placed as
  their parameters. With "drops", the MoE's dropped assignments of a
  forward at the start parameters (`moe_mlp_ep(stats=)`).
* "ckpt": llama's smoke config on (2, 2): a step, a mesh save, a step;
  then a restore on (2, 2) and its step (the uninterrupted run's bits),
  and a restore on (4, 1) (the logical arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from _sp_common import unflatten

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.launch import make_mesh
from repro_torch.launch.train import (batch_to, loss_and_grads,
                                      make_train_step, shardings_for)
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import make_rules
from repro_torch.tree import leaves, tree_map

OCFG = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)


def _batches(inp, c):
    out, i = [], 0
    while f"{c}/batch{i}/tokens" in inp:
        out.append({k: inp[f"{c}/batch{i}/{k}"]
                    for k in ("tokens", "targets", "frames")
                    if f"{c}/batch{i}/{k}" in inp})
        i += 1
    return out


def _setup(inp, c, shape):
    cfg = get_config(str(inp[c + "/arch"]), smoke=True)
    model = build_model(cfg, device="cpu")
    mesh = make_mesh(shape, ("data", "model"), backend="gloo", device="cpu")
    rules = make_rules(mesh)
    full = bridge.params_from_numpy(unflatten(inp, c + "/params/"))
    pspecs, ospecs = shardings_for(model, mesh, rules, full)
    return model, mesh, rules, full, pspecs, ospecs


def _clone(tree):
    """A copy (`shard_tree` hands a replicated leaf over as it is, and the
    step updates in place)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def _run(model, mesh, rules, params, opt, batches, steps):
    """The steps from (params, opt) (updated in place): per step its
    start's loss and gradients, then the state after it."""
    step = make_train_step(model, OCFG, mesh, rules)
    rec = []
    for i in range(steps + 1):
        b = batch_to(batches[i], "cpu")
        loss, grads = loss_and_grads(model, params, b, mesh=mesh, rules=rules)
        got = {"loss": loss, "grads": grads}
        if i < steps:
            params, opt, met = step(params, opt, b)
            got.update(params=_clone(params), m=_clone(opt.m),
                       v=_clone(opt.v), grad_norm=met["grad_norm"],
                       step_loss=met["loss"])
        rec.append(got)
    return rec


def task_train(_, inp):
    out = {}
    for c in [str(v) for v in inp["train_cases"]]:
        shape = tuple(int(v) for v in str(inp[c + "/mesh"]).split("x"))
        model, mesh, rules, full, pspecs, ospecs = _setup(inp, c, shape)
        batches = _batches(inp, c)
        steps = int(inp[c + "/steps"])
        params = _clone(bridge.shard_tree(full, pspecs, mesh))
        opt = adamw.init(params, mesh=mesh, specs=pspecs,
                         moment_specs=ospecs.m)
        res = {"coords": dict(mesh.coords),
               "moment_shapes": tree_map(lambda t: tuple(t.shape), opt.m)}
        if f"{c}/drops" in inp:
            from repro_torch.models import transformer
            stats = {}
            orig = transformer.moe_mlp_ep
            transformer.moe_mlp_ep = (
                lambda *a, **kw: orig(*a, stats=stats, **kw))
            try:
                with torch.no_grad():
                    model.loss_fn(params, batch_to(batches[0], "cpu"),
                                  mesh=mesh, rules=rules)
            finally:
                transformer.moe_mlp_ep = orig
            res["drops"] = stats.get("drops", 0)
        mesh.reset_bill()
        res["steps"] = _run(model, mesh, rules, params, opt, batches, steps)
        res["bill"] = mesh.bill()
        if f"{c}/zero1_ab" in inp:
            params = _clone(bridge.shard_tree(full, pspecs, mesh))
            opt = adamw.init(params, mesh=mesh, specs=pspecs)
            res["replicated"] = _run(model, mesh, rules, params, opt,
                                     batches, steps)
        out[c] = res
    return out


def task_ckpt(_, inp):
    c = "ckpt"
    model, mesh, rules, full, pspecs, ospecs = _setup(inp, c, (2, 2))
    batches = _batches(inp, c)
    step = make_train_step(model, OCFG, mesh, rules)
    params = _clone(bridge.shard_tree(full, pspecs, mesh))
    opt = adamw.init(params, mesh=mesh, specs=pspecs, moment_specs=ospecs.m)
    params, opt, _ = step(params, opt, batches[0])
    ckdir = str(inp["ckpt_dir"])
    checkpoint.save(ckdir, (params, opt), 1, mesh=mesh, specs=(pspecs, ospecs))
    saved = _clone((params, opt))
    params, opt, _ = step(params, opt, batches[1])
    out = {"uninterrupted": _clone((params, opt)), "saved": saved}
    # restart on the same mesh: the state saved, then the same step
    like = _clone(saved)
    (rp, ro), st = checkpoint.restore_latest(ckdir, like,
                                             shardings=(pspecs, ospecs),
                                             mesh=mesh)
    out["restored_step"] = st
    out["restored_equal"] = all(
        torch.equal(a, b) for a, b in zip(
            leaves((rp, ro)), leaves(saved)))
    rp, ro, _ = step(rp, ro, batches[1])
    out["resumed"] = _clone((rp, ro))
    # restart on (4, 1): another mesh of the same ranks
    mesh41 = make_mesh((4, 1), ("data", "model"), backend="gloo",
                       device="cpu")
    rules41 = make_rules(mesh41)
    p41, o41 = shardings_for(model, mesh41, rules41, full)
    like41 = (bridge.shard_tree(full, p41, mesh41),
              adamw.init(bridge.shard_tree(full, p41, mesh41), mesh=mesh41,
                         specs=p41, moment_specs=o41.m))
    out["restored41"] = checkpoint.restore(ckdir, 1, like41,
                                           shardings=(p41, o41), mesh=mesh41)
    out["coords41"] = dict(mesh41.coords)
    out["coords"] = dict(mesh.coords)
    return out


TASKS = {"train": task_train, "ckpt": task_ckpt}
