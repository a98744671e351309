"""Dry run of the port: every (arch x shape x mesh) cell, one rank at a time.

The JAX package proves a production cell coherent by lowering and
compiling the real step with `ShapeDtypeStruct` stand-ins on 512 host
devices (`repro.launch.dryrun`). The port runs SPMD, one process a rank,
so its counterpart runs the real step of ONE rank (rank 0 by default) on
the meta device, under a `parallel.sharding.ShadowMesh`: every tensor has
its shape and dtype and no storage, every collective is billed as the
live mesh bills it and moves no data. A shape that does not fit anywhere
raises, and the cell's status is "error", as a failed compile is there.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k [--multi-pod] [--selector S] [--out out.json]

A cell's JSON (`run_cell`):
  * "memory": {"argument_size_in_bytes", "output_size_in_bytes",
    "alias_size_in_bytes"} of one rank, counted as XLA counts them on the
    same cell (`cell_bytes`): the arguments are the rank's blocks of the
    parameters (`param_specs`), of the ZeRO-1 moments and count (train,
    `shardings_for`) or of the decode state (`state_specs`), and of the
    inputs sharded over "batch"; the outputs are what the step returns
    (parameters, optimizer state and three f32 metrics; the logits; the
    logits and the state), the logits in the sharding XLA propagates to
    them (their constraint: ("batch", "seq", "vocab"), or ("batch",
    "vocab") for one decode token) plus XLA's 8-byte table entry for each
    element of a tuple result; the alias is what the step donates (the
    state; the parameters and optimizer state). "per_rank" splits the
    arguments into "params", "moments", "state" and "inputs". No
    temporary size is given: the meta run cannot know the activations
    (`chip_smoke.py`'s `[dryrun]` measures two cells' peaks on the card).
  * "bill": {axis: {tag: {"calls", "bytes"}}}, the shadow rank's bill;
    "collectives": the same calls by the reference's HLO op names
    (psum, pmax, pmin and `enter`'s backward are all-reduces, all_gather
    an all-gather, all_to_all an all-to-all), each op's count and the
    bytes of its result, as the reference's `parse_collectives` counts
    them; "reduce-scatter" and "collective-permute" stay 0 (the port
    issues neither). A loop whose trip count depends on the data (SP-GVR's
    secant, histogram and snap rounds) is billed at its iteration cap,
    as the reference scales a while body by its cap.
  * "model_flops_per_device": 6 (train) or 2 (prefill, decode) x the
    active parameters x the cell's tokens / devices (`model_flops`),
    under its own name: the reference's "flops_per_device" is XLA's count.
  * "arch", "shape", "multi_pod", "n_devices", "kind", "params",
    "active_params", "status" ("ok", "skipped" or "error") and "lower_s",
    the meta run's seconds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.bridge import block_shape
from repro_torch.parallel.sharding import (HLO_COLLECTIVES, ShadowMesh,
                                           block_slices, make_rules,
                                           overrides_for)
from repro_torch.tree import leaves, spec_leaves, spec_map

COLLECTIVES = HLO_COLLECTIVES
FLOPS_SOURCE = "6N/2N model FLOPs, attention not counted"
SKIP_REASON = "shape inapplicable to family (DESIGN §Arch-applicability)"
TUPLE_ENTRY_BYTES = 8     # XLA's pointer table: bytes a tuple result element
METRICS = 3               # the train step's f32 scalars: loss, grad_norm, lr


# ---------------------------------------------------------------- FLOPs ----

def model_flops(cfg, shape, n_devices: int = 1) -> float:
    """6 (train) or 2 (prefill, decode) x active parameters x the cell's
    tokens (batch x sequence; one a row for decode), over `n_devices`."""
    s = _cell(shape)
    tokens = s["global_batch"] * (1 if s["kind"] == "decode"
                                  else s["seq_len"])
    per_token = 6 if s["kind"] == "train" else 2
    return per_token * cfg.active_param_count() * tokens / n_devices


def train_flops(cfg, b: int, s: int) -> tuple:
    """(total, attention) model FLOPs of one train step on one device: 6 x
    the weights a token uses x tokens (the tied head counted, the indexer
    and the embedding gather not), the remat forward of the layers (2 x
    layer weights x tokens), and the blockwise attention's two einsums
    over every block pair (the reference skips none): 4 B S^2 H hd a
    layer for each of the forward, the remat forward and the backward's
    two."""
    d, hd, l = cfg.d_model, cfg.hd, cfg.n_layers
    layer = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + 3 * d * cfg.d_ff)
    tokens = b * s
    attn = 4 * 4 * b * s * s * cfg.n_heads * hd * l
    return (6 * (l * layer + d * cfg.vocab) * tokens
            + 2 * l * layer * tokens + attn), attn


# ------------------------------------------------------------ the bytes ----

def _block(spec, shape, mesh) -> tuple:
    """The shape of a rank's block (refusing what NamedSharding refuses)."""
    block_slices(spec, shape, mesh, {a: 0 for a in mesh.axis_names})
    return block_shape(spec, shape, mesh)


def _bytes(spec, shape, dtype, mesh) -> int:
    return math.prod(_block(spec, tuple(shape), mesh)) * dtype.itemsize


def _tree_bytes(specs, shapes, mesh) -> int:
    return sum(_bytes(sp, t.shape, t.dtype, mesh)
               for sp, t in zip(spec_leaves(specs), leaves(shapes)))


def param_shapes(model):
    """The parameter tree on the meta device (shapes and dtypes only)."""
    return dataclasses.replace(model, device=torch.device("meta")).init_params()


def state_shapes(model, shape):
    """The decode state of a decode cell on the meta device."""
    s = _cell(shape)
    return model.mod.init_decode_state(model.cfg, s["global_batch"],
                                       s["seq_len"], device="meta")


def _cell(shape) -> dict:
    """A cell: a `SHAPES` name, or a dict of its keys ("kind", "seq_len",
    "global_batch", "seq_sharded") for other shapes (the tests')."""
    from repro_torch.models.api import SHAPES
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_specs(model, shape, rules) -> dict:
    """The inputs of a train or prefill cell, each sharded over "batch"."""
    return {k: rules.spec("batch", *(None,) * (len(v.shape) - 1),
                          sizes=v.shape)
            for k, v in model.input_specs(shape).items()}


def opt_specs(model, mesh, rules, pshapes):
    """The optimizer state's specs (`launch.train.shardings_for`)."""
    from repro_torch.launch.train import shardings_for
    return shardings_for(model, mesh, rules, pshapes)[1]


def cell_bytes(model, shape, mesh, rules, pshapes=None) -> dict:
    """One rank's argument, output and alias bytes of the cell's step, as
    XLA's `memory_analysis()` counts them (see the module docstring), and
    the arguments split by kind. Nothing is allocated. `pshapes`:
    `param_shapes(model)`, when the caller has it."""
    s = _cell(shape)
    kind, b = s["kind"], s["global_batch"]
    pshapes = param_shapes(model) if pshapes is None else pshapes
    pspecs = model.param_specs(rules)
    params = _tree_bytes(pspecs, pshapes, mesh)
    n_params = len(leaves(pshapes))
    moments = state = 0
    if kind in ("train", "prefill"):
        ins = model.input_specs(shape)
        inputs = sum(_bytes(sp, ins[k].shape, ins[k].dtype, mesh)
                     for k, sp in batch_specs(model, shape, rules).items())
    else:
        inputs = _bytes(rules.spec("batch", sizes=(b,)), (b,), torch.int32,
                        mesh)
    if kind == "train":
        ospecs = opt_specs(model, mesh, rules, pshapes)
        moments = 2 * sum(_bytes(sp, t.shape, torch.float32, mesh)
                          for sp, t in zip(spec_leaves(ospecs.m),
                                           leaves(pshapes)))
        moments += torch.int32.itemsize            # count, replicated
        alias = params + moments
        n_out = 3 * n_params + 1 + METRICS
        output = alias + METRICS * 4 + TUPLE_ENTRY_BYTES * n_out
    elif kind == "prefill":
        logits = (b, s["seq_len"], model.cfg.vocab)
        alias = 0
        output = _bytes(rules.spec("batch", "seq", "vocab", sizes=logits),
                        logits, _dtype(model.cfg), mesh)
    else:
        sshapes = state_shapes(model, shape)
        sspecs = model.state_specs(rules, batch=b, max_len=s["seq_len"],
                                   seq_sharded=bool(s.get("seq_sharded")))
        state = _tree_bytes(sspecs, sshapes, mesh)
        logits = (b, model.cfg.vocab)
        alias = state
        output = (state + _bytes(rules.spec("batch", "vocab", sizes=logits),
                                 logits, torch.float32, mesh)
                  + TUPLE_ENTRY_BYTES * (1 + len(leaves(sshapes))))
    return {"memory": {"argument_size_in_bytes": params + moments + state
                       + inputs,
                       "output_size_in_bytes": output,
                       "alias_size_in_bytes": alias},
            "per_rank": {"params": params, "moments": moments,
                         "state": state, "inputs": inputs}}


def _dtype(cfg) -> torch.dtype:
    from repro_torch.models.transformer import torch_dtype
    return torch_dtype(cfg.dtype)


# ------------------------------------------------------- the shadow step ----

def shadow_args(model, shape, mesh, rules,
                pshapes=None) -> Dict[str, Any]:
    """The arguments of the cell's step on the rank of the `ShadowMesh`
    `mesh`, on its device, as the port's steps take them: the rank's
    blocks of the parameters (`init_params(mesh=)`), of the optimizer
    state (train, `adamw.init(mesh=)`) and of the decode state, and the
    global batch or tokens, which every rank passes whole. The decode
    state and the inputs are zeros: off the meta device the caller gives
    them values."""
    s = _cell(shape)
    dev = mesh.device
    model = dataclasses.replace(model, device=dev)
    params = model.init_params(seed=0, mesh=mesh, rules=rules)
    if s["kind"] == "decode":
        b, n = s["global_batch"], s["seq_len"]
        specs = model.state_specs(rules, batch=b, max_len=n,
                                  seq_sharded=bool(s.get("seq_sharded")))
        state = spec_map(lambda sp, t: torch.zeros(
            _block(sp, t.shape, mesh), dtype=t.dtype, device=dev),
            specs, state_shapes(model, shape))
        return {"params": params, "state": state,
                "tokens": torch.zeros((b,), dtype=torch.int32, device=dev)}
    batch = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
             for k, v in model.input_specs(shape).items()}
    if s["kind"] == "prefill":
        return {"params": params, "batch": batch}
    from repro_torch.optim import adamw
    ospecs = opt_specs(model, mesh, rules, param_shapes(model)
                       if pshapes is None else pshapes)
    opt = adamw.init(params, mesh=mesh, specs=model.param_specs(rules),
                     moment_specs=ospecs.m)
    return {"params": params, "opt_state": opt, "batch": batch}


def run_shadow(model, shape, mesh, rules, args) -> Dict[str, Any]:
    """Run the cell's real step on the rank of the `ShadowMesh` `mesh`
    over `args` (`shadow_args`): the AdamW train step (forward, backward
    and update), the forward for prefill, one `serve_step` for decode.
    Returns the step's outputs."""
    s = _cell(shape)
    if s["kind"] == "train":
        from repro_torch.launch.train import make_train_step
        from repro_torch.optim import adamw
        step = make_train_step(model, adamw.AdamWConfig(), mesh, rules)
        return step(args["params"], args["opt_state"], args["batch"])
    with torch.no_grad():
        if s["kind"] == "prefill":
            batch = args["batch"]
            kw = {k: batch[k] for k in ("patch_embeds", "frames")
                  if k in batch}
            return model.forward_train(args["params"], batch["tokens"],
                                       mesh=mesh, rules=rules, **kw)
        return model.serve_step(args["params"], args["state"], args["tokens"],
                                mesh=mesh, rules=rules,
                                seq_sharded=bool(s.get("seq_sharded")))


def shadow_step(model, shape, mesh, rules,
                coords: Optional[Dict[str, int]] = None,
                device="meta", pshapes=None) -> Dict[str, Any]:
    """The cell's real step for the rank at `coords` (rank 0 by default)
    of `mesh` (an `AbstractMesh`), run to its end on `device` under a
    `ShadowMesh`: its bill by axis and tag, the same calls under the
    reference's collective names, and the shapes of the outputs. Raises
    where a shape does not fit."""
    shadow = ShadowMesh([mesh.shape[a] for a in mesh.axis_names],
                        mesh.axis_names, coords=coords, device=device)
    args = shadow_args(model, shape, shadow, rules, pshapes)
    shadow.reset_bill()
    out = run_shadow(model, shape, shadow, rules, args)
    return {"bill": shadow.bill(), "collectives": shadow.collectives(),
            "outputs": _shapes(out)}


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return list(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_shapes(v) for v in tree]
    return None


# ---------------------------------------------------------------- a cell ----

def run_cell(arch: str, shape: str, multi_pod: bool,
             selector: Optional[str] = None) -> dict:
    """One cell of the sweep on the production mesh (see the module
    docstring for its fields)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.api import SHAPES, build_model, supported_shapes

    t_start = time.time()
    cfg = get_config(arch)
    if selector:
        cfg = dataclasses.replace(cfg, dsa=dataclasses.replace(
            cfg.dsa, selector=selector))
    if shape not in supported_shapes(cfg):
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "skipped", "reason": SKIP_REASON}
    mesh = make_production_mesh(multi_pod=multi_pod)
    kind = SHAPES[shape]["kind"]
    model = build_model(cfg, device="meta")
    rules = make_rules(mesh, overrides=overrides_for(cfg, kind))
    result = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
              "n_devices": mesh.size, "kind": kind,
              "params": cfg.param_count(),
              "active_params": cfg.active_param_count()}
    pshapes = param_shapes(model)
    result.update(cell_bytes(model, shape, mesh, rules, pshapes))
    shadow = shadow_step(model, shape, mesh, rules, pshapes=pshapes)
    result["bill"] = shadow["bill"]
    result["collectives"] = shadow["collectives"]
    result["model_flops_per_device"] = model_flops(cfg, shape, mesh.size)
    result["flops_source"] = FLOPS_SOURCE
    result["lower_s"] = round(time.time() - t_start, 3)
    result["status"] = "ok"
    return result


def error_result(arch, shape, multi_pod, e: BaseException) -> dict:
    """A cell that raised, recorded as the reference records it."""
    import traceback
    return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--selector", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    try:
        res = run_cell(args.arch, args.shape, args.multi_pod,
                       selector=args.selector)
    except Exception as e:  # noqa: BLE001 — record the failure for the table
        res = error_result(args.arch, args.shape, args.multi_pod, e)
    js = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    print(js if res.get("status") != "ok" else
          json.dumps({k: v for k, v in res.items()
                      if k not in ("traceback",)}, indent=1))
    sys.exit(0 if res.get("status") in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
