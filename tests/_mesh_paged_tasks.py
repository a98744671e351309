"""The port's side of `test_torch_mesh_paged.py`: the "mesh_paged" task of
`_sp_rank.py` (one process a rank, 4 gloo ranks on the CPU).

Each case of inputs.npz on its ("data", "model") mesh, this rank holding
the blocks `param_specs` and `paged_state_specs` give it: the step forms'
greedy ticks of `serve_step_paged(..., mesh=, rules=)` (the rank's rows'
logits and feedback, the global `length`, the next global tokens, the
bill), its pool blocks after them; the verify forms' one tick
(`serve_step_spec_paged`, drafts from its own "token" ticks as
`_mesh_paged_jax.py` makes them); and the dense mesh step's ticks over
the same cache content (`serve_step(mesh=)`), which the paged "token" and
"gather" forms equal bit for bit."""

from __future__ import annotations

import torch

from _sp_common import unflatten

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import make_mesh
from repro_torch.models.api import build_model
from repro_torch.models.tensor_parallel import Placement
from repro_torch.parallel.sharding import make_rules
from repro_torch.tree import tree_map

STEP_FORMS = {"token": dict(paged_attn="fused", gather_granularity="token"),
              "page": dict(paged_attn="fused", gather_granularity="page"),
              "gather": dict(paged_attn="gather"),
              "fallback": dict(paged_attn="fused")}
POOLS = ("k_pages", "v_pages", "idx_k_pages")
FEEDBACK = ("prev_topk", "topk_valid", "sel_gvr", "length")


def _drafts(tok0, greedy, vocab):
    d = torch.stack([tok0, greedy[0], greedy[1]], 1).int()
    d[3, 2] = (d[3, 2] + 1) % vocab
    return d


def task_mesh_paged(_, inp):
    out = {}
    for c in [str(v) for v in inp["cases"]]:
        cfg = get_config(str(inp[c + "/arch"]), smoke=True)
        model = build_model(cfg, device="cpu")
        mesh = make_mesh(tuple(int(v) for v in inp[c + "/shape"]),
                         ("data", "model"), backend="gloo", device="cpu")
        rules = make_rules(mesh)
        params = bridge.shard_tree(
            bridge.params_from_numpy(unflatten(inp, c + "/params/")),
            model.param_specs(rules), mesh)
        tok0 = torch.from_numpy(inp[c + "/tokens"].copy())
        b = tok0.shape[0]
        entry = rules.spec("batch", sizes=(b,))[0]

        def state(prefix, paged=True):
            full = bridge.params_from_numpy(unflatten(inp, c + prefix))
            n = (full["page_table"].shape[1] * full["k_pages"].shape[2]
                 if paged else full["k"].shape[2])
            specs = (model.paged_state_specs(
                rules, batch=b, max_len=n,
                num_pages=full["k_pages"].shape[1] - 1,
                page_size=full["k_pages"].shape[2]) if paged else
                model.state_specs(rules, batch=b, max_len=n))
            # shard_tree's blocks of replicated leaves are views: clone
            return tree_map(torch.clone, bridge.shard_tree(full, specs, mesh))

        def ticks(step, st):
            tok, recs = tok0, []
            for t in range(int(inp["ticks"])):
                mesh.reset_bill()
                logits, st = step(st, tok, t)
                bill = mesh.bill()
                tok = logits.argmax(-1).int()
                if entry is not None:
                    tok = mesh.axis(entry).all_gather(tok, dim=0, tiled=True)
                recs.append({"logits": logits, "tokens": tok, "bill": bill,
                             **{k: st[k] for k in FEEDBACK}})
            return recs, st

        res = {"rows": Placement(mesh, rules, b).rows, "coords": mesh.coords}
        forms = [str(v) for v in inp[c + "/forms"]]
        for form in [f for f in forms if f in STEP_FORMS]:
            mwp0 = inp.get(f"{c}/mwp/{form}")

            def step(st, tok, t, form=form, mwp0=mwp0):
                mwp = (torch.from_numpy(mwp0.copy()) if mwp0 is not None
                       and t == 0 else None)
                return model.serve_step_paged(params, st, tok, mesh=mesh,
                                              rules=rules, min_write_pos=mwp,
                                              **STEP_FORMS[form])

            recs, st = ticks(step, state("/fallback/" if form == "fallback"
                                         else "/paged/"))
            res[form] = {"ticks": recs, **{k: st[k] for k in POOLS}}
        res["dense"], _ = ticks(
            lambda st, tok, t: model.serve_step(params, st, tok, mesh=mesh,
                                                rules=rules),
            state("/dense/", paged=False))
        greedy = [r["tokens"] for r in res["token"]["ticks"]]
        for vk in [f for f in forms if f in ("scan", "mq")]:
            st = state("/paged/")
            mesh.reset_bill()
            got = model.serve_step_spec_paged(
                params, st, _drafts(tok0, greedy, cfg.vocab), mesh=mesh,
                rules=rules, verify_kernel=vk,
                draft_len=torch.from_numpy(inp[c + "/draft_len"].copy()),
                max_accept=torch.from_numpy(inp[c + "/max_accept"].copy()))
            res[vk] = {"bill": mesh.bill(),
                       **dict(zip(("out_tokens", "accept", "logits",
                                   "sel_pos"), got[:4])),
                       **{k: got[4][k] for k in FEEDBACK + POOLS}}
        out[c] = res
    return out


TASKS = {"mesh_paged": task_mesh_paged}
