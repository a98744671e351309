"""One rank of the sequence-sharded port tests (see `_sp_common.py`).

    python tests/_sp_rank.py TASK RANK WORLD INIT_METHOD INPUT_DIR OUT_DIR

Joins a gloo group of WORLD ranks on the CPU, runs TASK over
INPUT_DIR/inputs.npz and saves its results to OUT_DIR/rank{RANK}.pt.
Imports the port only (no jax)."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _sp_common import unflatten  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import init_seq_group, make_seq_mesh  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

GVR_CASES = ("normal", "ties", "lognormal", "k1")
DSA_CONFIGS = (("llama", "llama3.2-1b"), ("danube", "h2o-danube-3-4b"))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def task_gvr(mesh, inp):
    """sp_gvr_topk on each case, and the mesh's refusals."""
    from repro_torch.core import sp_gvr_topk
    out = {}
    for name in GVR_CASES:
        idx, thr, iters = sp_gvr_topk(_t(inp[f"gvr_x_{name}"]),
                                      _t(inp[f"gvr_prev_{name}"]),
                                      int(inp[f"gvr_k_{name}"]), mesh)
        out[name] = (idx, thr, iters)
    errors = {}
    for key, kw in (("size", dict(seq_shards=mesh.size + 1)),
                    ("backend", dict(seq_shards=mesh.size, backend="nccl"))):
        try:
            make_seq_mesh(device="cpu", **kw)
        except ValueError as exc:
            errors[key] = str(exc)
    out["errors"] = errors
    out["bill"] = mesh.bill()
    return out


def task_dsa(mesh, inp):
    """The paged layer (llama and danube's window) and the contiguous
    layer, each rank over its own shard."""
    from repro_torch.sparse.sp_dsa import make_sp_dsa, sp_dsa_decode_paged_local
    r, s = mesh.rank, mesh.size
    out = {}
    for c, arch in DSA_CONFIGS:
        cfg = get_config(arch, smoke=True)
        table = _t(inp[f"{c}_sp_table"])
        span = table.shape[1] // s
        ps = inp[f"{c}_sp_k_pages"].shape[3]
        res = sp_dsa_decode_paged_local(
            _t(inp[f"{c}_q"]), _t(inp[f"{c}_sp_k_pages"][0, r]),
            _t(inp[f"{c}_sp_v_pages"][0, r]),
            table[:, r * span:(r + 1) * span].contiguous(),
            {"wq": _t(inp[f"{c}_wq"]), "w": _t(inp[f"{c}_w"])},
            _t(inp[f"{c}_h"]), _t(inp[f"{c}_sp_idx_k_pages"][0, r]),
            _t(inp[f"{c}_prev_topk"][0]), _t(inp[f"{c}_topk_valid"][0]),
            _t(inp[f"{c}_length"]), k=int(inp[f"{c}_prev_topk"].shape[-1]),
            scale=cfg.hd ** -0.5, heads=cfg.dsa.indexer_heads,
            dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base,
            shard_offset=r * span * ps, page_size=ps,
            max_candidates=cfg.dsa.max_candidates,
            swa_window=cfg.swa_window, mesh=mesh)
        out[c] = tuple(res)
    cfg = get_config("llama3.2-1b", smoke=True)
    nl = inp["c_kc"].shape[1] // s
    local = {key: _t(inp[key][:, r * nl:(r + 1) * nl])
             for key in ("c_kc", "c_vc", "c_ikc")}
    layer = make_sp_dsa(mesh, k=int(inp["c_prev"].shape[-1]),
                        scale=cfg.hd ** -0.5, heads=cfg.dsa.indexer_heads,
                        dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base)
    res = layer(_t(inp["c_q"]), local["c_kc"], local["c_vc"], local["c_ikc"],
                _t(inp["c_h"]), {"wq": _t(inp["llama_wq"]),
                                 "w": _t(inp["llama_w"])},
                _t(inp["c_prev"]), _t(inp["c_lengths"]), _t(inp["c_knew"]),
                _t(inp["c_vnew"]), _t(inp["c_iknew"]))
    out["contig"] = tuple(res)
    return out


def _model(inp):
    cfg = get_config("llama3.2-1b", smoke=True)
    model = build_model(cfg, device="cpu")
    return model, bridge.params_from_numpy(unflatten(inp, "params/"))


def _sp_state(inp, mesh):
    r = mesh.rank
    state = {key: _t(inp[f"sp_{key}"][:, r:r + 1])
             for key in ("k_pages", "v_pages", "idx_k_pages")}
    state.update(page_table=_t(inp["sp_table"]), length=_t(inp["length"]),
                 prev_topk=_t(inp["prev_topk"]),
                 topk_valid=_t(inp["topk_valid"]),
                 sel_gvr=torch.zeros(inp["topk_valid"].shape, dtype=torch.bool))
    return state


def task_step(mesh, inp):
    """4 non-speculative steps, then one verify tick by each body."""
    model, params = _model(inp)
    state = _sp_state(inp, mesh)
    tok = _t(inp["tokens"])
    steps = []
    for _ in range(4):
        logits, state = model.serve_step_sp_paged(params, state, tok, mesh=mesh)
        steps.append({"logits": logits, **{k: state[k] for k in (
            "prev_topk", "topk_valid", "sel_gvr", "length")}})
        tok = logits.argmax(-1).int()
    spec = {}
    for vk in ("scan", "mq"):
        st = {k: v.clone() for k, v in state.items()}
        toks = torch.cat([tok[:, None], _t(inp["draft"])], 1)
        res = model.serve_step_sp_spec_paged(
            params, st, toks, mesh=mesh, draft_len=_t(inp["draft_len"]),
            max_accept=_t(inp["max_accept"]), verify_kernel=vk)
        spec[vk] = res[:4] + ({k: res[4][k] for k in (
            "prev_topk", "topk_valid", "sel_gvr", "length")},)
    pools = {k: state[k] for k in ("k_pages", "v_pages", "idx_k_pages")}
    return {"steps": steps, "spec": spec, "pools": pools,
            "bill": mesh.bill()}


def task_engine(mesh, inp):
    """The coverage trace through `DecodeEngine(seq_shards=S)`, and with
    `full` the preemption and speculative traces too."""
    from _sp_traces import engine_runs
    model, params = _model(inp)
    full = bool(inp["full"])
    return engine_runs(model, params, pre=full, spec=full,
                       seq_shards=mesh.size, mesh=mesh)


def _mesh_run(inp, c, run):
    """Case c's greedy ticks on the mesh `run` names ("DxM", "DxMsp":
    sequence-sharded), this rank's blocks from `bridge.shard_tree`: per
    tick its rows' logits and feedback, the next global tokens (the rows'
    argmax gathered over the batch axis) and the collective bill; the
    local shapes of the parameter leaves. A spec the mesh refuses gives
    its error instead."""
    import dataclasses
    from repro_torch.launch import make_mesh
    from repro_torch.models.tensor_parallel import Placement
    from repro_torch.parallel.sharding import make_rules
    d, m = (int(v) for v in run.rstrip("sp").split("x"))
    seq = run.endswith("sp")
    cfg = dataclasses.replace(get_config(str(inp[c + "/arch"]), smoke=True),
                              n_kv_heads=int(inp[c + "/kvh"]))
    model = build_model(cfg, device="cpu")
    mesh = make_mesh((d, m), ("data", "model"), backend="gloo", device="cpu")
    rules = make_rules(mesh)
    params = bridge.params_from_numpy(unflatten(inp, c + "/params/"))
    state = bridge.params_from_numpy(unflatten(inp, c + "/state/"))
    tok = _t(inp[c + "/tokens"])
    b = tok.shape[0]
    n = state["k"].shape[2] if "k" in state else 1   # ssm: no cache
    lp = bridge.shard_tree(params, model.param_specs(rules), mesh)
    try:
        st = bridge.shard_tree(state, model.state_specs(
            rules, batch=b, max_len=n, seq_sharded=seq), mesh)
    except ValueError as exc:
        return {"error": str(exc)}
    rows = Placement(mesh, rules, b).rows
    entry = rules.spec("batch", sizes=(b,))[0]
    ticks = []
    for _ in range(int(inp["ticks"])):
        mesh.reset_bill()
        logits, st = model.serve_step(lp, st, tok, mesh=mesh, rules=rules,
                                      seq_sharded=seq)
        bill = mesh.bill()
        tok = logits.argmax(-1).int()
        if entry is not None:
            tok = mesh.axis(entry).all_gather(tok, dim=0, tiled=True)
        ticks.append({"logits": logits, "prev_topk": st.get("prev_topk"),
                      "tokens": tok, "bill": bill})

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{prefix}{k}/").items()}
        return {prefix[:-1]: tuple(tree.shape)}

    return {"rows": (rows.start, rows.stop), "ticks": ticks,
            "shapes": shapes(lp)}


def task_mesh(mesh, inp):
    """Every case's runs on its meshes over this group of 4 ranks, and
    `moe_mlp_ep` on (2, 2) where the inputs hold "ep/*"."""
    out = {}
    for c in [str(v) for v in inp["cases"]]:
        for run in [str(v) for v in inp[c + "/runs"] if str(v) != "ref"]:
            out[f"{c}/{run}"] = _mesh_run(inp, c, run)
    if "ep/x_drop" in inp:
        from repro_torch.launch import make_mesh
        from repro_torch.models import layers
        from repro_torch.models.tensor_parallel import Placement
        from repro_torch.parallel.sharding import make_rules
        m = make_mesh((2, 2), ("data", "model"), backend="gloo", device="cpu")
        rules = make_rules(m)
        r = m.coords["model"]
        w = [_t(inp["ep/" + k]) for k in ("router", "w_gate", "w_up", "w_down")]
        e = w[1].shape[0]
        w[1:] = [x[r * e // 2:(r + 1) * e // 2] for x in w[1:]]
        top_k, cf = int(inp["ep/top_k"]), float(inp["ep/cf"])
        for name in ("x_drop", "x_dec"):
            x = _t(inp["ep/" + name])
            rows = Placement(m, rules, x.shape[0]).rows
            out[f"ep/{name}"] = (
                (rows.start, rows.stop),
                layers.moe_mlp_ep(x[rows], *w, top_k=top_k,
                                  capacity_factor=cf, mesh=m),
                layers.moe_ep_drops(x[rows], w[0], top_k=top_k,
                                    num_experts=e, capacity_factor=cf, ep=2))
        out["ep/bill"] = m.bill()
        x = _t(inp["ep/x_drop"]).to(torch.bfloat16)
        wb = w[:1] + [v.to(torch.bfloat16) for v in w[1:]]
        rows = Placement(m, rules, x.shape[0]).rows
        out["ep/x_drop_bf16"] = (
            (rows.start, rows.stop),
            layers.moe_mlp_ep(x[rows], *wb, top_k=top_k, capacity_factor=cf,
                              mesh=m).float(),
            layers.moe_ep_drops(x[rows], w[0], top_k=top_k, num_experts=e,
                                capacity_factor=cf, ep=2))
        ax = m.axis("model")
        got = {}
        for split, concat, tiled in ((0, 1, True), (1, 0, True), (2, 0, True),
                                     (0, 2, False), (0, 0, False)):
            t = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
            got[(split, concat, tiled)] = ax.all_to_all(
                t * 10 + ax.rank, split, concat, tiled=tiled)
        out["all_to_all"] = (ax.rank, got)
    return out


TASKS = {"gvr": task_gvr, "dsa": task_dsa, "step": task_step,
         "engine": task_engine, "mesh": task_mesh}
from _mesh_train_tasks import TASKS as _TRAIN_TASKS  # noqa: E402
from _mesh_paged_tasks import TASKS as _PAGED_TASKS  # noqa: E402
TASKS.update(_TRAIN_TASKS)
TASKS.update(_PAGED_TASKS)


def main(argv) -> int:
    task, rank, world, init, inp_dir, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    init_seq_group(rank, world, init_method=init, backend="gloo",
                   timeout_s=120)
    mesh = make_seq_mesh(world, backend="gloo", device="cpu")
    inp = dict(np.load(Path(inp_dir) / "inputs.npz"))
    out = TASKS[task](mesh, inp)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    mesh.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
