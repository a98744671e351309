"""Model facade of the PyTorch port: family dispatch and the device choice.

`build_model(cfg)` runs on the card: with no `device` it takes "cuda" and
raises when there is none — pass `device="cpu"` to run the plain PyTorch
path on the CPU, as the tests do. It never falls back silently.

The slot-wise and paged hooks are looked up in the family's module, as
the JAX package's facade looks them up: the enc-dec, ssm and hybrid
families define none (the reference serves them step by step only), so
their axis maps are None and the other hooks raise NotImplementedError —
and `DecodeEngine` refuses them with the reference's ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.parallel.sharding import block_slices
from repro_torch.tree import tree_map
from . import encdec, hybrid, ssm, transformer
from .config import ModelConfig
from .tensor_parallel import require_live

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "audio": encdec, "ssm": ssm, "hybrid": hybrid}

# the reference's shape cells
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1,
                      seq_sharded=True),
}


class ShapeDtype(NamedTuple):
    """An array's shape and dtype, with no storage (`jax.ShapeDtypeStruct`)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: "cuda" unless the caller asks for
    another; raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the PyTorch port runs on the GPU by "
            "default. Pass device='cpu' to run its plain PyTorch path on the "
            "CPU.")
    return dev


def _mesh_kw(mesh, rules) -> Dict[str, Any]:
    """A step's mesh keywords: none without a mesh, else the live mesh
    (`require_live`) and its rules."""
    if mesh is None:
        return {}
    require_live(mesh)
    return {"mesh": mesh, "rules": rules}


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    mod: object
    device: torch.device

    def init_params(self, seed: int = 0, *, mesh=None, rules=None):
        """Random-init parameters on the model's device, drawn from a
        `torch.Generator` on that device seeded with `seed`. Under a `mesh`
        and its `rules`: this rank's blocks of those same parameters (the
        blocks `bridge.shard_tree` of `param_specs` gives), each layer cut
        as it is drawn, so a rank never holds its whole tree. On the meta
        device (the dry run's shapes) nothing is drawn."""
        generator = (None if self.device.type == "meta" else
                     torch.Generator(device=self.device).manual_seed(seed))
        if mesh is None:
            return self.mod.init_params(self.cfg, generator, self.device)
        specs = self.param_specs(rules)

        def block(path, x):
            spec = specs
            for key in path.split("/"):
                spec = spec[key]
            spec = spec[len(spec) - x.dim():]
            return x[block_slices(spec, x.shape, mesh, mesh.coords)].contiguous()

        return self.mod.init_params(self.cfg, generator, self.device,
                                    block=block)

    def param_specs(self, rules):
        """The spec of every parameter leaf under `rules` (the reference's
        tree and names; `bridge.shard_tree` takes a rank's blocks)."""
        return self.mod.param_specs(self.cfg, rules)

    def state_specs(self, rules, *, batch, max_len, seq_sharded=False):
        """The spec of every leaf of `init_decode_state(batch, max_len)`."""
        return self.mod.state_specs(self.cfg, rules, batch=batch,
                                    max_len=max_len, seq_sharded=seq_sharded)

    def paged_state_specs(self, rules, *, batch, max_len, num_pages,
                          page_size):
        """The spec of every leaf of `init_paged_decode_state(...)`: the
        pools by KV head and global over the batch axes, the table and
        `length` replicated, the feedback leaves by batch."""
        return self._hook("paged_state_specs", "paged decode state")(
            self.cfg, rules, batch=batch, max_len=max_len,
            num_pages=num_pages, page_size=page_size)

    def input_specs(self, shape) -> Dict[str, ShapeDtype]:
        """The inputs of a shape cell (a `SHAPES` name, or a dict of the
        same keys) as shapes and dtypes: tokens and targets (frames for
        the audio family, patch embeddings for the vlm) for train and
        prefill; one token a row for decode, whose cache is
        `decode_state_specs`."""
        s = SHAPES[shape] if isinstance(shape, str) else shape
        b, sl = s["global_batch"], s["seq_len"]
        if s["kind"] not in ("train", "prefill"):
            return {"tokens": ShapeDtype((b,), torch.int32)}
        specs = {"tokens": ShapeDtype((b, sl), torch.int32),
                 "targets": ShapeDtype((b, sl), torch.int32)}
        dt = transformer.torch_dtype(self.cfg.dtype)
        if self.cfg.family == "audio":
            specs["frames"] = ShapeDtype(
                (b, self.cfg.encoder_frames, self.cfg.d_model), dt)
        if self.cfg.num_patches:
            specs["patch_embeds"] = ShapeDtype(
                (b, self.cfg.num_patches, self.cfg.d_model), dt)
        return specs

    def decode_state_specs(self, shape: str) -> Dict[str, Any]:
        """The decode state of a decode shape cell as shapes and dtypes
        (built on the meta device: nothing is allocated)."""
        s = SHAPES[shape]
        if s["kind"] != "decode":
            raise ValueError(f"{shape!r} is not a decode shape cell")
        state = self.mod.init_decode_state(self.cfg, s["global_batch"],
                                           s["seq_len"], device="meta")
        return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype), state)

    def loss_fn(self, params, batch, *, mesh=None, rules=None):
        """Mean next-token cross-entropy of `batch`, a dict of tensors on
        the model's device (tokens, targets, optional mask; frames for
        the audio family, patch_embeds for the vlm). Under a `mesh` and
        its `rules`: params the rank's blocks, the batch global, and the
        loss this rank's share (`parallel/sharding.py`'s convention;
        `launch.train.loss_and_grads` sums it)."""
        return self.mod.loss_fn(params, batch, self.cfg, mesh=mesh,
                                rules=rules)

    def forward_train(self, params, tokens, **kw):
        """Training-path logits (B, S, V) under autograd; `kw` is the
        family's (`remat`, `frames`, `patch_embeds`, `mesh`, `rules`:
        under a mesh the logits of the rank's rows and vocabulary
        block)."""
        return self.mod.forward_train(params, tokens, self.cfg, **kw)

    def init_decode_state(self, batch, max_len, *, dtype=None):
        return self.mod.init_decode_state(self.cfg, batch, max_len,
                                          device=self.device, dtype=dtype)

    def _hook(self, name: str, what: str):
        """The family module's `name`, or NotImplementedError saying the
        family has no `what`."""
        fn = getattr(self.mod, name, None)
        if fn is None:
            raise NotImplementedError(
                f"family {self.cfg.family!r} has no {what}")
        return fn

    def _axes(self, name: str) -> Optional[Dict[str, int]]:
        fn = getattr(self.mod, name, None)
        return fn(self.cfg) if fn is not None else None

    def state_batch_axes(self) -> Optional[Dict[str, int]]:
        """Slot axis of every dense-state leaf, or None when the family
        has no slot-wise state (the engine refuses it)."""
        return self._axes("state_batch_axes")

    def state_merge_axes(self) -> Optional[Dict[str, int]]:
        return self._axes("state_merge_axes")

    def init_paged_decode_state(self, batch, max_len, *, num_pages, page_size,
                                dtype=None):
        return self._hook("init_paged_decode_state", "paged decode state")(
            self.cfg, batch, max_len, num_pages=num_pages,
            page_size=page_size, device=self.device, dtype=dtype)

    def paged_state_batch_axes(self) -> Optional[Dict[str, int]]:
        """Slot axis of each per-slot paged-state leaf, or None when the
        family has no paged decode path."""
        return self._axes("paged_state_batch_axes")

    def reset_slot_state(self, state, slot, *, seq_len_hint=None):
        return self._hook("reset_slot_state", "slot-wise state reset")(
            self.cfg, state, slot, seq_len_hint=seq_len_hint)

    def recycle_slot_state(self, state, slot):
        return self._hook("recycle_slot_state", "slot-wise state recycle")(
            self.cfg, state, slot)

    def serve_step(self, params, state, tokens, *, min_write_pos=None,
                   mesh=None, rules=None, seq_sharded: bool = False):
        """One dense-layout decode step (see transformer.serve_step; the
        enc-dec, ssm and hybrid steps take no `min_write_pos`, as the
        reference's). Under a `mesh` (`launch.make_mesh`) and its `rules`
        each rank of every family passes the blocks `bridge.shard_tree`
        gives it of the parameters and state and the global tokens, and
        gets the logits of its own batch rows. `seq_sharded` reaches the
        hybrid step alone, as in the reference's facade."""
        kw = {} if min_write_pos is None else {"min_write_pos": min_write_pos}
        kw.update(_mesh_kw(mesh, rules))
        if self.cfg.family == "hybrid":
            kw["seq_sharded"] = seq_sharded
        return self.mod.serve_step(params, state, tokens, self.cfg, **kw)

    def serve_step_paged(self, params, state, tokens, *, min_write_pos=None,
                         paged_attn="fused", gather_granularity="token",
                         mesh=None, rules=None):
        """One paged decode step (see transformer.serve_step_paged). Under
        a `mesh` and its `rules` each rank passes its blocks of the
        parameters and of the paged state (`paged_state_specs`) and the
        global tokens, and gets the logits of its own batch rows; only
        the transformer family has paged forms, as in the reference."""
        return self._hook("serve_step_paged", "paged serve_step")(
            params, state, tokens, self.cfg, min_write_pos=min_write_pos,
            paged_attn=paged_attn, gather_granularity=gather_granularity,
            **_mesh_kw(mesh, rules))

    def serve_step_spec_paged(self, params, state, tokens, *, draft_len,
                              max_accept, eos_id=-1, min_write_pos=None,
                              paged_attn="fused", verify_kernel="scan",
                              gather_granularity="token", mesh=None,
                              rules=None):
        """One speculative verify tick over the paged layout (see
        transformer.serve_step_spec_paged); under a `mesh`, as
        `serve_step_paged`."""
        return self._hook("serve_step_spec_paged",
                          "speculative paged serve_step")(
            params, state, tokens, self.cfg, draft_len=draft_len,
            max_accept=max_accept, eos_id=eos_id,
            min_write_pos=min_write_pos, paged_attn=paged_attn,
            verify_kernel=verify_kernel,
            gather_granularity=gather_granularity, **_mesh_kw(mesh, rules))


    # ---- sequence-sharded paged decode (the SP-GVR serving path) --------
    # `mesh` is this rank's `launch.make_seq_mesh(S)`: every rank calls
    # these with the same arguments and holds its own shard of the pools.

    def init_sp_paged_decode_state(self, batch, max_len, *,
                                   num_pages_per_shard, page_size,
                                   seq_shards, dtype=None):
        """This rank's sequence-sharded paged state: its shard of the page
        pools (extent 1 on the shard axis) and the shard-local block
        table."""
        return self._hook("init_sp_paged_decode_state",
                          "sequence-sharded paged decode state")(
            self.cfg, batch, max_len, num_pages_per_shard=num_pages_per_shard,
            page_size=page_size, seq_shards=seq_shards, device=self.device,
            dtype=dtype)

    def sp_paged_state_batch_axes(self) -> Optional[Dict[str, int]]:
        """Slot axis of each per-slot leaf of the sharded paged state, or
        None when the family has no sharded decode path."""
        return self._axes("sp_paged_state_batch_axes")

    def serve_step_sp_paged(self, params, state, tokens, *, mesh,
                            min_write_pos=None):
        """One sequence-sharded paged decode step on this rank (see
        transformer.serve_step_sp_paged); bit-identical to
        `serve_step_paged(paged_attn="fused")`."""
        return self._hook("serve_step_sp_paged",
                          "sequence-sharded paged serve_step")(
            params, state, tokens, self.cfg, mesh=mesh,
            min_write_pos=min_write_pos)

    def serve_step_sp_spec_paged(self, params, state, tokens, *, mesh,
                                 draft_len, max_accept, eos_id=-1,
                                 min_write_pos=None, verify_kernel="scan"):
        """Sequence-sharded speculative verify tick on this rank (see
        transformer.serve_step_sp_spec_paged)."""
        return self._hook("serve_step_sp_spec_paged",
                          "sequence-sharded speculative paged serve_step")(
            params, state, tokens, self.cfg, mesh=mesh, draft_len=draft_len,
            max_accept=max_accept, eos_id=eos_id,
            min_write_pos=min_write_pos, verify_kernel=verify_kernel)


def supported_shapes(cfg: ModelConfig) -> list:
    """The shape cells that apply to `cfg`: long_500k only for the
    sub-quadratic families (ssm, hybrid)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model for `cfg` on `device` ("cuda" by default)."""
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return Model(cfg=cfg, mod=mod, device=resolve_device(device))
