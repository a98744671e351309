"""Training entry point of the port and its train step.

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 50 --smoke \
        [--batch B --seq S] [--checkpoint-dir D --checkpoint-every N --resume] \
        [--device cpu]

It runs on the card ("cuda") unless `--device` names another device, and
raises when CUDA is asked for and absent; it never falls back. The train
step is the reference's: the loss and its gradient over every parameter
leaf (autograd; a leaf the loss does not reach gets a zero gradient, as
`jax.value_and_grad` gives), then `optim.adamw.update`, which writes the
new parameters and moments in place.

Under a ("data", "model") mesh (`make_train_step(model, cfg, mesh,
rules)`, on every rank of `launch.init_mesh_group`'s group) params and
the optimizer state are the rank's blocks under `shardings_for`'s specs
(`bridge.shard_tree`, or `model.init_params(mesh=)` and
`adamw.init(mesh=)`), the batch is the global one, and the step follows
`parallel/sharding.py`'s loss convention: each leaf's gradient summed
over the batch axes its spec does not name, the loss reported summed.
The CLI takes no mesh, as the reference's.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.models.api import build_model
from repro_torch.models.tensor_parallel import Placement
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import P, _names
from repro_torch.tree import leaves, spec_leaves, spec_map, unflatten


def batch_to(batch, device):
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(model, params, batch, *, mesh=None, rules=None):
    """(loss, grads): the mean cross-entropy of `batch` and its gradient,
    a tree like `params` with zeros where the loss does not reach. Under
    a `mesh`: the whole loss on every rank and the rank's blocks of the
    gradient, each summed over the batch axes its spec does not name
    (leaves of one dtype and axes in one collective)."""
    flat = leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    loss = model.loss_fn(unflatten(params, live), batch, mesh=mesh,
                         rules=rules)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    loss = loss.detach()
    if mesh is not None:
        pl = Placement(mesh, rules, batch["tokens"].shape[0])
        loss = pl.batch_sum(loss, "loss")
        batch_axes = _names(pl.batch_axes)
        groups = {}
        for i, spec in enumerate(spec_leaves(model.param_specs(rules))):
            named = {a for e in spec for a in _names(e)}
            axes = tuple(a for a in batch_axes if a not in named)
            if axes:
                groups.setdefault((grads[i].dtype, axes), []).append(i)
        for (_, axes), idx in groups.items():
            buf = torch.cat([grads[i].reshape(-1) for i in idx])
            for a in reversed(axes):
                buf = mesh.axis(a).psum(buf, "grad")
            for i, part in zip(idx, buf.split([grads[i].numel()
                                               for i in idx])):
                grads[i] = part.view(grads[i].shape)
    return loss, unflatten(params, grads)


def make_train_step(model, cfg_opt: adamw.AdamWConfig, mesh=None,
                    rules=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), metrics
    {"loss", "grad_norm", "lr"} as 0-dim device tensors. `batch` may hold
    numpy arrays (`data.pipeline`); they go to the parameters' device.
    Under a `mesh` and its `rules` every rank calls it with its blocks
    and the global batch (see the module docstring); a moment block that
    is a ZeRO-1 slice of its parameter's is updated as one."""
    specs = None if mesh is None else model.param_specs(rules)

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device
        loss, grads = loss_and_grads(model, params, batch_to(batch, device),
                                     mesh=mesh, rules=rules)
        params, opt_state, metrics = adamw.update(
            grads, opt_state, params, cfg_opt, mesh=mesh, specs=specs)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def shardings_for(model, mesh, rules, params_shapes, opt_shapes=None):
    """The spec trees of the parameters and of the optimizer state, the
    reference's: (param_specs, OptState(m, v: zero1_specs, count: P())),
    which `bridge.shard_tree` takes. `params_shapes` holds the
    parameters' global shapes; `opt_shapes` is taken and unused, as the
    reference's."""
    pspecs = model.param_specs(rules)
    zero1 = adamw.zero1_specs(pspecs, rules, sizes_tree=params_shapes)
    return pspecs, adamw.OptState(m=zero1, v=spec_map(lambda s: s, zero1),
                                  count=P())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_stream
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    ocfg = adamw.AdamWConfig(total_steps=max(args.steps, 10))

    params = model.init_params(seed=0)
    opt_state = adamw.init(params)
    step0 = 0
    if args.checkpoint_dir and args.resume:
        from repro_torch.checkpoint.checkpoint import restore_latest
        restored = restore_latest(args.checkpoint_dir, (params, opt_state))
        if restored is not None:
            (params, opt_state), step0 = restored
            print(f"resumed from step {step0}")

    train_step = make_train_step(model, ocfg)
    stream = synthetic_stream(vocab=cfg.vocab, batch=args.batch,
                              seq=args.seq, seed=step0,
                              family=cfg.family, cfg=cfg)
    t0 = time.time()
    for step in range(step0, args.steps):
        batch = next(stream)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            from repro_torch.checkpoint.checkpoint import save
            save(args.checkpoint_dir, (params, opt_state), step + 1)
    print("done")


if __name__ == "__main__":
    main()
