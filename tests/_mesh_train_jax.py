"""The JAX side of the mesh training tests (`_sp_common.run_jax`, argv[1]
the inputs' folder): the reference's `make_train_step(model, ocfg, mesh,
rules)` and its loss gradient, jitted, on 4 forced host devices, placed
by `shardings_for`.

For each case of "train_cases": per step the loss and gradients at the
step's start (`jax.value_and_grad` of `loss_fn(mesh=, rules=)`), then
the step; the parameters, moments and metrics after it. With "drops",
the assignments `moe_mlp_ep`'s capacity drops in a forward at the start
parameters, counted by the reference body's own routing lines (per data
shard and EP slice) beside each call."""

import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "tests")
from _sp_common import flatten, unflatten  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.train import make_train_step, shardings_for  # noqa: E402
from repro.models import transformer  # noqa: E402
from repro.models.api import build_model  # noqa: E402
from repro.optim import adamw  # noqa: E402
from repro.parallel.sharding import make_rules  # noqa: E402

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}
OCFG = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100)


def traced_drops(x, rw, top_k, e, cf, ep, data):
    """The reference body's dropped assignments over x (B, S, D)."""
    b, s, dm = x.shape
    shards = x.reshape(data, b // data * s, dm) if b % data == 0 else x.reshape(1, b * s, dm)
    total = jnp.zeros((), jnp.int32)
    for xb in shards:
        t_pad = -(-xb.shape[0] // ep) * ep
        xb = jnp.pad(xb, ((0, t_pad - xb.shape[0]), (0, 0)))
        for sl in jnp.split(xb, ep):
            _, eidx = jax.lax.top_k(sl @ rw, top_k)
            a = sl.shape[0] * top_k
            flat_e = eidx.reshape(a)
            cap = max(int(a / e * cf), 4)
            order = jnp.argsort(flat_e, stable=True)
            sorted_e = flat_e[order]
            seg = jnp.searchsorted(sorted_e, jnp.arange(e))
            rank_sorted = jnp.arange(a, dtype=jnp.int32) - seg[sorted_e]
            rank = jnp.zeros(a, jnp.int32).at[order].set(rank_sorted)
            total = total + (rank >= cap).sum()
    return total


def batch_of(c, i):
    return {k: jnp.asarray(inp[f"{c}/batch{i}/{k}"])
            for k in ("tokens", "targets", "frames")
            if f"{c}/batch{i}/{k}" in inp}


for c in [str(v) for v in inp.get("train_cases", [])]:
    shape = tuple(int(v) for v in str(inp[c + "/mesh"]).split("x"))
    mesh = make_mesh(shape, ("data", "model"))
    rules = make_rules(mesh)
    model = build_model(get_config(str(inp[c + "/arch"]), smoke=True))
    params = jax.tree.map(jnp.asarray, unflatten(inp, c + "/params/"))
    shapes = jax.eval_shape(lambda: params)
    psh, osh = shardings_for(model, mesh, rules, shapes, None)
    params = jax.device_put(params, psh)
    opt = jax.device_put(adamw.init(params), osh)
    if c + "/drops" in inp:
        cfg = model.cfg
        tally = []
        orig = transformer.moe_mlp_ep

        def counted(x, router_w, *w, **kw):
            jax.debug.callback(lambda v: tally.append(int(v)), traced_drops(
                x, router_w, cfg.moe.top_k, cfg.moe.num_experts,
                cfg.moe.capacity_factor, shape[1], shape[0]))
            return orig(x, router_w, *w, **kw)

        transformer.moe_mlp_ep = counted
        jax.block_until_ready(jax.jit(lambda p, b: model.loss_fn(
            p, b, mesh=mesh, rules=rules))(params, batch_of(c, 0)))
        transformer.moe_mlp_ep = orig
        out[c + "/drops"] = np.asarray(sum(tally))
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, mesh=mesh, rules=rules)))
    step = jax.jit(make_train_step(model, OCFG, mesh, rules))
    for i in range(int(inp[c + "/steps"]) + 1):
        b = batch_of(c, i)
        loss, grads = grad(params, b)
        out[f"{c}/{i}/loss"] = np.asarray(loss)
        out.update(flatten(jax.tree.map(np.asarray, grads), f"{c}/{i}/grads/"))
        if i < int(inp[c + "/steps"]):
            params, opt, met = step(params, opt, b)
            out[f"{c}/{i}/grad_norm"] = np.asarray(met["grad_norm"])
            out[f"{c}/{i}/step_loss"] = np.asarray(met["loss"])
            for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
                out.update(flatten(jax.tree.map(np.asarray, tree),
                                   f"{c}/{i}/{name}/"))

np.savez(tmp + "/jax.npz", **out)
