"""The JAX side of the mesh tests: the reference's decode steps on forced
host-device meshes (`_sp_common.run_jax`, argv[1] the inputs' folder).

Each case of inputs.npz names a smoke config (and its KV heads), its
parameters, decode state and tokens, and its runs: "ref" (no mesh) or
"DxM" / "DxMsp" (`serve_step(mesh=make_mesh((D, M)), rules=make_rules(mesh),
seq_sharded=...)`), each TICKS greedy ticks, jitted. With "ep/*" inputs it
also runs `moe_mlp_ep` on (2, 2) and counts the drops of its routing."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "tests")
from _sp_common import unflatten  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import layers  # noqa: E402
from repro.models.api import build_model  # noqa: E402
from repro.parallel.sharding import make_rules  # noqa: E402

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}


def stepper(model, run):
    if run == "ref":
        return jax.jit(lambda p, s, t: model.serve_step(p, s, t))
    d, m = (int(v) for v in run.rstrip("sp").split("x"))
    mesh = make_mesh((d, m), ("data", "model"))
    rules = make_rules(mesh)
    return jax.jit(lambda p, s, t: model.serve_step(
        p, s, t, mesh=mesh, rules=rules, seq_sharded=run.endswith("sp")))


for c in [str(v) for v in inp["cases"]]:
    cfg = dataclasses.replace(get_config(str(inp[c + "/arch"]), smoke=True),
                              n_kv_heads=int(inp[c + "/kvh"]))
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, unflatten(inp, c + "/params/"))
    for run in [str(v) for v in inp[c + "/runs"]]:
        step = stepper(model, run)
        state = jax.tree.map(jnp.asarray, unflatten(inp, c + "/state/"))
        tok = jnp.asarray(inp[c + "/tokens"])
        try:
            for t in range(int(inp["ticks"])):
                logits, state = step(params, state, tok)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                out[f"{c}/{run}/logits{t}"] = np.asarray(logits)
                if "prev_topk" in state:
                    out[f"{c}/{run}/prev_topk{t}"] = np.asarray(state["prev_topk"])
                out[f"{c}/{run}/tokens{t}"] = np.asarray(tok)
        except Exception as exc:  # recorded: the test names what it expects
            out[f"{c}/{run}/error"] = np.asarray(type(exc).__name__)


def ep_drops(x, rw, top_k, e, cf, ep, data):
    """The reference body's dropped assignments (its lines, per data shard
    and EP slice; a batch that does not divide the data axis is
    replicated, so it counts once)."""
    b, s, dm = x.shape
    total = 0
    for xb in (np.split(x, data) if b % data == 0 else [x]):
        xt = xb.reshape(-1, dm)
        t_pad = -(-xt.shape[0] // ep) * ep
        xt = np.concatenate([xt, np.zeros((t_pad - xt.shape[0], dm), xt.dtype)])
        for sl in np.split(xt, ep):
            _, eidx = jax.lax.top_k(jnp.asarray(sl) @ jnp.asarray(rw), top_k)
            a = sl.shape[0] * top_k
            flat_e = eidx.reshape(a)
            cap = max(int(a / e * cf), 4)
            order = jnp.argsort(flat_e, stable=True)
            sorted_e = flat_e[order]
            seg_start = jnp.searchsorted(sorted_e, jnp.arange(e))
            rank_sorted = jnp.arange(a, dtype=jnp.int32) - seg_start[sorted_e]
            rank = jnp.zeros(a, jnp.int32).at[order].set(rank_sorted)
            total += int((rank >= cap).sum())
    return total


if "ep/x_drop" in inp:
    mesh = make_mesh((2, 2), ("data", "model"))
    w = [jnp.asarray(inp["ep/" + k]) for k in ("router", "w_gate", "w_up", "w_down")]
    top_k, cf = int(inp["ep/top_k"]), float(inp["ep/cf"])
    f = jax.jit(lambda x, *w: layers.moe_mlp_ep(
        x, *w, top_k=top_k, capacity_factor=cf, mesh=mesh))
    for name in ("x_drop", "x_dec"):
        x = inp["ep/" + name]
        out[f"ep/{name}"] = np.asarray(f(jnp.asarray(x), *w))
        out[f"ep/{name}_dense"] = np.asarray(layers.moe_mlp_dense_fallback(
            jnp.asarray(x), *w, top_k=top_k))
        out[f"ep/{name}_drops"] = np.asarray(ep_drops(
            x, inp["ep/router"], top_k, w[1].shape[0], cf, 2, 2))
    # bf16 activations and experts, the router f32 (the served dtypes)
    xb = jnp.asarray(inp["ep/x_drop"]).astype(jnp.bfloat16)
    wb = w[:1] + [v.astype(jnp.bfloat16) for v in w[1:]]
    out["ep/x_drop_bf16"] = np.asarray(f(xb, *wb).astype(jnp.float32))
    out["ep/x_drop_bf16_drops"] = np.asarray(ep_drops(
        np.asarray(xb.astype(jnp.float32)), inp["ep/router"], top_k,
        w[1].shape[0], cf, 2, 2))

np.savez(tmp + "/jax.npz", **out)
