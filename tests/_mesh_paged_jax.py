"""The JAX side of `test_torch_mesh_paged.py`: the reference's paged decode
step and verify tick on a forced host-device mesh and on one device
(`_sp_common.run_jax`, argv[1] the inputs' folder).

Each case of inputs.npz names a smoke config, its mesh shape, parameters,
paged state (and the fallback's, at a max_len <= dsa.min_n), tokens and
forms. A step form runs TICKS greedy ticks of `serve_step_paged(...,
mesh=, rules=)` ("mesh") and of the one-device step ("ref"), jitted, with
the form's `min_write_pos` at tick 0 where the inputs give one; a verify
form ("scan", "mq") runs one `serve_step_spec_paged` tick from the start
state whose draft is this side's own greedy tokens of the "token" form
(row 3's second draft token made wrong). The mesh step's state goes in
and comes out replicated on the mesh, so that its ticks share one
compile."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

sys.path.insert(0, "tests")
from _sp_common import unflatten  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models.api import build_model  # noqa: E402
from repro.parallel.sharding import make_rules  # noqa: E402

STEP_FORMS = {"token": dict(paged_attn="fused", gather_granularity="token"),
              "page": dict(paged_attn="fused", gather_granularity="page"),
              "gather": dict(paged_attn="gather"),
              "fallback": dict(paged_attn="fused")}
POOLS = ("k_pages", "v_pages", "idx_k_pages")
FEEDBACK = ("prev_topk", "topk_valid", "sel_gvr", "length")

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}


def drafts(tok0, greedy, vocab):
    """(B, 3) verify tokens: the last emitted token, then the greedy
    continuation with row 3's second draft token made wrong."""
    d = np.stack([tok0, greedy[0], greedy[1]], 1).astype(np.int32)
    d[3, 2] = (d[3, 2] + 1) % vocab
    return d


for c in [str(v) for v in inp["cases"]]:
    cfg = get_config(str(inp[c + "/arch"]), smoke=True)
    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, unflatten(inp, c + "/params/"))
    mesh = make_mesh(tuple(int(v) for v in inp[c + "/shape"]), ("data", "model"))
    rules = make_rules(mesh)
    rep = NamedSharding(mesh, PartitionSpec())
    forms = [str(v) for v in inp[c + "/forms"]]
    b = inp[c + "/tokens"].shape[0]
    greedy = {}
    for run, kw in (("ref", {}), ("mesh", dict(mesh=mesh, rules=rules))):
        place = (lambda x: jnp.asarray(x)) if run == "ref" else (
            lambda x: jax.device_put(x, rep))
        for form in [f for f in forms if f in STEP_FORMS]:
            opts = STEP_FORMS[form]
            step = jax.jit(lambda p, s, t, m, opts=opts, kw=kw:
                           model.serve_step_paged(p, s, t, min_write_pos=m,
                                                  **opts, **kw),
                           out_shardings=None if run == "ref" else rep)
            state = jax.tree.map(place, unflatten(
                inp, c + ("/fallback/" if form == "fallback" else "/paged/")))
            tok = place(inp[c + "/tokens"])
            key = f"{c}/{run}/{form}"
            toks = []
            for t in range(int(inp["ticks"])):
                mwp = inp.get(f"{c}/mwp/{form}") if t == 0 else None
                mwp = np.zeros((b,), np.int32) if mwp is None else mwp
                logits, state = step(params, state, tok, place(mwp))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                toks.append(np.asarray(tok))
                out[f"{key}/logits{t}"] = np.asarray(logits)
                out[f"{key}/tokens{t}"] = toks[-1]
                for k in FEEDBACK:
                    out[f"{key}/{k}{t}"] = np.asarray(state[k])
            for k in POOLS:
                out[f"{key}/{k}"] = np.asarray(state[k])
            if form == "token":
                greedy[run] = toks
        for vk in [f for f in forms if f in ("scan", "mq")]:
            tick = jax.jit(lambda p, s, t, dl, ma, vk=vk, kw=kw:
                           model.serve_step_spec_paged(
                               p, s, t, draft_len=dl, max_accept=ma,
                               verify_kernel=vk, **kw))
            state = jax.tree.map(jnp.asarray, unflatten(inp, c + "/paged/"))
            vt = drafts(inp[c + "/tokens"], greedy[run], cfg.vocab)
            res = tick(params, state, jnp.asarray(vt),
                       jnp.asarray(inp[c + "/draft_len"]),
                       jnp.asarray(inp[c + "/max_accept"]))
            key = f"{c}/{run}/{vk}"
            out[key + "/drafts"] = vt
            for name, v in zip(("out_tokens", "accept", "logits", "sel_pos"),
                               res[:4]):
                out[f"{key}/{name}"] = np.asarray(v)
            for k in FEEDBACK + POOLS:
                out[f"{key}/{k}"] = np.asarray(res[4][k])

np.savez(tmp + "/jax.npz", **out)
