"""Continuous-batching decode engine over the dense or paged KV layout,
PyTorch port.

One `DecodeEngine` owns a fixed pool of B slots (the batch axis of the
decode state). Per tick it:

  1. admits queued requests into freed slots (scheduler policy): under the
     paged layout the manager plans the prompt's pages — shared prefix
     pages by ref-count, the rest freshly allocated, queueing when the pool
     cannot hold them — and the `FeedbackPool` resets the slot's GVR
     feedback;
  2. streams one `prefill_chunk` of each PREFILL slot's prompt into the
     caches, token by token through a batch-1 view of the step (other
     slots untouched);
  3. runs ONE model step over the whole pool for the DECODE slots (paged:
     mapping, and copy-on-write protecting, each slot's write page first,
     preempting the lowest-priority slot under page pressure), samples
     their next tokens (greedy by default), and keeps the new per-slot
     state only for active rows (inactive rows write nothing: the dense
     step keeps their cache rows, the paged step sends them to the sink
     page);
  4. retires finished slots (eos or max_new_tokens), releasing their pages
     and poisoning their feedback rows.

Every served slot-tick is logged with the selector path that produced its
Top-K (`gvr`/`radix`/`exact`, or `dense` before the DSA gate opens), taken
from the step's own per-row report. `EngineReport` splits the counts by
phase; `gvr_hit_rate` is defined over decode ticks only.

Speculative decoding (`spec_depth=d`, paged layout only; `serve.spec`): a
host-side drafter proposes up to d next tokens per DECODE slot, the decode
tick becomes one verify tick over all d+1 positions
(`serve_step_spec_paged`, `verify_kernel="scan"` or `"mq"`), and the
acceptance and rollback return the state — length, feedback, block tables,
ref-counts — to the non-speculative trajectory, so greedy requests get the
non-speculative tokens. The method log keeps accepted positions only, one
entry per non-speculative tick they stand for. Sampled requests verify at
depth 0.

Preemption order under page pressure: reclaim cold prefix-cache pages
first; then preempt the PREFILL slot with the most remaining prompt tokens
(ties toward the latest admission); only if every other slot is decoding,
the DECODE slot with the fewest generated tokens. The victim returns to
the front of the queue and replays deterministically.

The engine runs on its model's device (the card unless the model was built
with device="cpu"). It serves `kv_layout="dense"` (the default) and
`kv_layout="paged"` with `paged_attn="fused"` or `"gather"` and
`gather_granularity="token"` or `"page"`, with or without speculation.

Sequence-sharded serving (`kv_layout="paged", seq_shards=S`): the engine
runs on each of the S ranks of a sequence mesh (`launch.make_seq_mesh`),
every rank the same host code over the same requests. The page pools
partition by logical token span, rank s holding shard s's pool
(`ShardedPagedKVManager`, `num_pages` counted per shard), and each tick
runs `serve_step_sp_paged` (SP-GVR selection, O(K) row assembly) on every
rank. Tokens, the method log and the reports are the single-device fused
engine's; admission, copy-on-write and preemption account per shard.

The dense layout has no prefix cache, so it reports `prefix_hit_tokens` 0
and `peak_page_utilization` 0.0, as the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import PAGED_NEVER_WRITE, check_paged_options

from . import sampling
from .feedback_pool import FeedbackPool
from .paged import PagedKVManager, PoolExhausted, ShardedPagedKVManager
from .scheduler import DECODE, DONE, PREFILL, QUEUED, Scheduler, make_scheduler
from .spec import NgramDrafter


@dataclasses.dataclass(eq=False)       # identity equality: the scheduler
class Request:                         # queue must never compare ndarray fields
    uid: int
    prompt: np.ndarray                 # (P,) int32 prompt tokens
    max_new_tokens: int = 16
    arrival: int = 0                   # tick at which the request may admit
    # sampling policy: temperature == 0 → greedy (the default)
    temperature: float = 0.0
    top_p: float = 1.0
    seed: Optional[int] = None         # sampling seed (default: uid)
    # speculative decoding: per-request draft-depth cap, clamped to the
    # engine's spec_depth; None = the engine's. Sampled requests verify at
    # depth 0.
    spec_depth: Optional[int] = None
    # lifecycle bookkeeping (engine-owned)
    phase: str = QUEUED
    slot: Optional[int] = None
    prefill_pos: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_at: Optional[int] = None
    finished_at: Optional[int] = None
    logits_log: List[np.ndarray] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # paged-layout internals
    _materialized: int = 0             # prompt positions backed by shared pages
    _skip: int = 0                     # prefill_pos at admission (cache skip)
    _key: Optional[torch.Generator] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.uid}: empty prompt")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"request {self.uid}: top_p must be in (0, 1], "
                             f"got {self.top_p}")
        if self.spec_depth is not None and self.spec_depth < 0:
            raise ValueError(f"request {self.uid}: spec_depth must be >= 0, "
                             f"got {self.spec_depth}")


@dataclasses.dataclass
class EngineReport:
    """One `run()` window's telemetry (every field is a delta over it).

    * `ticks` / `wall_s` — engine ticks driven and wall-clock seconds.
    * `decoded_tokens` / `prefill_tokens` — delivered work only: a
      preempted pass's tokens are rolled back when the request re-queues.
    * `completed` — requests that reached DONE inside the window.
    * `method_counts` — selector path per served slot-tick, both phases;
      `prefill_method_counts` / `decode_method_counts` split it by phase.
    * `gvr_hit_rate` (property) — GVR coverage of DECODE ticks only.
    * `preemptions` — slots evicted back to the queue under page pressure.
    * `prefix_hit_tokens` — prompt tokens served from the prefix cache.
    * `peak_page_utilization` — max pool utilization over the window.
    * `spec_ticks` / `spec_drafted` / `spec_accepted` — per-slot verify
      passes that carried a draft, draft tokens proposed, draft tokens
      accepted; `spec_acceptance_rate` (property) = accepted / drafted.
    * `gvr_hit_rate_by_draft_pos` — per verify position j (0: the input
      token, j >= 1: draft depth j), the share of executed positions the
      GVR path served.
    """
    ticks: int
    wall_s: float
    decoded_tokens: int
    prefill_tokens: int
    completed: int
    method_counts: Dict[str, int]
    prefill_method_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    decode_method_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    preemptions: int = 0
    prefix_hit_tokens: int = 0
    peak_page_utilization: float = 0.0
    spec_ticks: int = 0
    spec_drafted: int = 0
    spec_accepted: int = 0
    gvr_hit_rate_by_draft_pos: List[float] = dataclasses.field(
        default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.decoded_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def spec_acceptance_rate(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    @property
    def gvr_hit_rate(self) -> float:
        total = sum(self.decode_method_counts.values())
        return (self.decode_method_counts.get("gvr", 0) / total
                if total else 0.0)

    @property
    def prefill_gvr_hit_rate(self) -> float:
        total = sum(self.prefill_method_counts.values())
        return (self.prefill_method_counts.get("gvr", 0) / total
                if total else 0.0)


class DecodeEngine:
    """Fixed-slot continuous-batching decode engine (see module docstring)."""

    def __init__(self, model, params, *, num_slots: int, max_len: int,
                 prefill_chunk: int = 8, scheduler="fifo",
                 eos_id: Optional[int] = None, record_logits: bool = False,
                 kv_layout: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_caching: bool = True,
                 paged_attn: str = "fused", gather_granularity: str = "token",
                 seq_shards: int = 1, mesh=None, spec_depth: int = 0,
                 drafter=None, verify_kernel: str = "scan"):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        check_paged_options(paged_attn, gather_granularity)
        if gather_granularity == "page" and kv_layout != "paged":
            raise ValueError(
                "gather_granularity='page' requires kv_layout='paged' "
                "(page-granular reads address the page pools)")
        if gather_granularity == "page" and seq_shards > 1:
            raise ValueError(
                "gather_granularity='page' is not supported under "
                "seq_shards > 1: the sharded attention assembles selected "
                "rows via the O(K) psum, not the paged gather")
        if verify_kernel not in ("scan", "mq"):
            raise ValueError(f"unknown verify_kernel {verify_kernel!r} "
                             f"(expected 'scan' or 'mq')")
        if spec_depth < 0:
            raise ValueError(f"spec_depth must be >= 0, got {spec_depth}")
        if spec_depth > 0 and kv_layout != "paged":
            raise ValueError(
                "spec_depth > 0 requires kv_layout='paged': the verify "
                "tick runs through the paged step and its rollback is the "
                "page-cursor rewind (serve.spec)")
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.eos_id = eos_id
        self.record_logits = record_logits
        self.scheduler: Scheduler = (scheduler if isinstance(scheduler, Scheduler)
                                     else make_scheduler(scheduler))
        self.kv_layout = kv_layout
        self.paged_attn = paged_attn
        self.gather_granularity = gather_granularity
        self.verify_kernel = verify_kernel
        self.seq_shards = int(seq_shards)
        self.mesh = mesh
        self.pool = FeedbackPool(model, self.num_slots)

        # speculative decoding: the drafter proposes up to spec_depth tokens
        # per DECODE slot per tick (default: n-gram self-drafting)
        self.spec_depth = int(spec_depth)
        if drafter is None and self.spec_depth > 0:
            drafter = NgramDrafter()
        self.drafter = drafter
        self.spec_ticks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._spec_pos_hits = np.zeros((self.spec_depth + 1,), np.int64)
        self._spec_pos_total = np.zeros((self.spec_depth + 1,), np.int64)

        self.kv: Optional[PagedKVManager] = None
        if self.seq_shards > 1:
            self._init_sharded(kv_layout, paged_attn, int(page_size),
                               num_pages, prefix_caching)
        elif kv_layout == "paged":
            # the page pools are pool-global: every per-slot leaf is merged
            self._axes = self._merge_axes = model.paged_state_batch_axes()
            if self._axes is None:
                raise ValueError(f"model family {model.cfg.family!r} does "
                                 f"not expose a paged decode state")
            if self.max_len % int(page_size) != 0:
                raise ValueError(f"max_len ({self.max_len}) must be a "
                                 f"multiple of page_size ({page_size})")
            pages_per_slot = self.max_len // int(page_size)
            self.num_pages = (int(num_pages) if num_pages is not None
                              else self.num_slots * pages_per_slot)
            self.kv = PagedKVManager(num_slots=self.num_slots,
                                     max_len=self.max_len,
                                     page_size=int(page_size),
                                     num_pages=self.num_pages,
                                     prefix_caching=prefix_caching)
            self.state = model.init_paged_decode_state(
                self.num_slots, self.max_len, num_pages=self.num_pages,
                page_size=int(page_size))
        else:
            self._axes = model.state_batch_axes()
            if self._axes is None:
                raise ValueError(f"model family {model.cfg.family!r} does not "
                                 f"expose slot-wise decode state")
            # the caches are written in place by the step (inactive rows
            # kept): only the leaves it returns anew are merged
            self._merge_axes = model.state_merge_axes()
            self.state = model.init_decode_state(self.num_slots, self.max_len)

        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self.tick_count = 0
        self.decoded_tokens = 0
        self.prefill_tokens = 0
        self.preemptions = 0
        self.peak_occupancy = 0
        self.peak_pages_in_use = 0
        self.peak_pool_util = 0.0
        self.completed: List[Request] = []
        # per-request: [(tick, phase, method), ...]
        self.method_log: Dict[int, List[Tuple[int, str, str]]] = {}

        cfg = self.cfg
        self._use_dsa = bool(cfg.dsa.enabled) and self.max_len > cfg.dsa.min_n
        # the selector's path for cold rows, from its auto gate over
        # n = max_len (auto + use_dsa means n > min_n: radix, never exact)
        if not self._use_dsa:
            self._cold_method = "dense"
        elif cfg.dsa.selector != "auto":
            self._cold_method = cfg.dsa.selector
        else:
            self._cold_method = "radix"

    def _init_sharded(self, kv_layout: str, paged_attn: str, page_size: int,
                      num_pages: Optional[int], prefix_caching: bool) -> None:
        """The sequence-sharded layout: the reference's checks and
        messages, this rank's mesh, the per-shard manager and state."""
        if kv_layout != "paged":
            raise ValueError("seq_shards > 1 requires kv_layout='paged' "
                             "(the dense layout has no sharded pool)")
        if paged_attn != "fused":
            raise ValueError(
                "seq_shards > 1 requires paged_attn='fused': the "
                "sharded step is block-table-native per shard and "
                "never materializes a logical view to 'gather' from")
        cfg = self.cfg
        if not (cfg.dsa.enabled and self.max_len > cfg.dsa.min_n):
            raise ValueError(
                "seq_shards > 1 requires the DSA gate open "
                f"(dsa.enabled and max_len > dsa.min_n="
                f"{cfg.dsa.min_n}): the sequence-sharded step has no "
                "dense fallback attention")
        if self.max_len % (page_size * self.seq_shards) != 0:
            raise ValueError(
                f"max_len ({self.max_len}) must be a multiple of "
                f"page_size × seq_shards ({page_size}×{self.seq_shards})"
                f" — shard token spans must be page-aligned")
        if self.mesh is None:
            from repro_torch.launch.mesh import make_seq_mesh
            self.mesh = make_seq_mesh(self.seq_shards, device=self.device)
        if ("seq" not in self.mesh.axis_names
                or self.mesh.shape["seq"] != self.seq_shards):
            raise ValueError(
                f"mesh must carry a 'seq' axis of extent "
                f"{self.seq_shards}, got {dict(self.mesh.shape)}")
        self._axes = self._merge_axes = self.model.sp_paged_state_batch_axes()
        if self._axes is None:
            raise ValueError(f"model family {cfg.family!r} does "
                             f"not expose a sequence-sharded paged "
                             f"decode state")
        span_pages = self.max_len // page_size // self.seq_shards
        # `num_pages` is PER SHARD here: the per-device KV budget
        per_shard = (int(num_pages) if num_pages is not None
                     else self.num_slots * span_pages)
        self.num_pages = per_shard * self.seq_shards
        self.kv = ShardedPagedKVManager(
            num_slots=self.num_slots, max_len=self.max_len,
            page_size=page_size, num_pages_per_shard=per_shard,
            seq_shards=self.seq_shards, prefix_caching=prefix_caching)
        self.state = self.model.init_sp_paged_decode_state(
            self.num_slots, self.max_len, num_pages_per_shard=per_shard,
            page_size=page_size, seq_shards=self.seq_shards)

    # ---- device steps ---------------------------------------------------

    def _step(self, state, tokens: torch.Tensor, min_write_pos):
        """Layout dispatch: one model step over the given (sub-)pool."""
        if self.seq_shards > 1:
            return self.model.serve_step_sp_paged(
                self.params, state, tokens, min_write_pos=min_write_pos,
                mesh=self.mesh)
        if self.kv is None:
            return self.model.serve_step(self.params, state, tokens,
                                         min_write_pos=min_write_pos)
        return self.model.serve_step_paged(
            self.params, state, tokens, min_write_pos=min_write_pos,
            paged_attn=self.paged_attn,
            gather_granularity=self.gather_granularity)

    def _merge_active(self, new_state, state, active: torch.Tensor):
        """Keep `new_state` only for active rows; the caches pass through
        (inactive rows kept their cache rows or wrote to the sink page)."""
        merged = {}
        for key, arr in new_state.items():
            ax = self._merge_axes.get(key)
            if ax is None:
                merged[key] = arr
                continue
            shape = [1] * arr.dim()
            shape[ax] = self.num_slots
            merged[key] = torch.where(active.reshape(shape), arr, state[key])
        return merged

    def _prefill_slot(self, tokens: np.ndarray, slot: int,
                      min_write_pos: int):
        """Stream `tokens` of one slot's prompt through batch-1 steps,
        leaving every other slot untouched. Positions below
        `min_write_pos` skip their cache write (shared-prefix replay).
        Returns the last token's logits (1, V) and whether layer 0's GVR
        path served the first token."""
        sub = {k: (v if ax is None else v.narrow(ax, slot, 1))
               for k, v in self.state.items()
               for ax in [self._axes.get(k)]}
        mwp = torch.tensor([min_write_pos], dtype=torch.int32, device=self.device)
        tok = torch.as_tensor(tokens, dtype=torch.int32).to(self.device)
        logits, first_gvr = None, False
        for i in range(len(tokens)):
            logits, sub = self._step(sub, tok[i:i + 1], mwp)
            if i == 0 and "sel_gvr" in sub:
                first_gvr = bool(sub["sel_gvr"][0, 0])
        state = dict(self.state)
        for k, ax in self._merge_axes.items():
            full = state[k].clone()
            full.narrow(ax, slot, 1).copy_(sub[k])
            state[k] = full
        self.state = state
        return logits, first_gvr

    # ---- host-side lifecycle --------------------------------------------

    def submit(self, request: Request) -> None:
        total = len(request.prompt) + request.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt ({len(request.prompt)}) + "
                f"max_new ({request.max_new_tokens}) exceeds max_len "
                f"({self.max_len})")
        if self.kv is not None and not self.kv.can_ever_hold(total):
            raise ValueError(f"request {request.uid}: "
                             f"{self.kv.sizing_error(total)} — it could never "
                             f"admit")
        self.method_log.setdefault(request.uid, [])
        self.scheduler.submit(request)

    def _log(self, req: Request, method: str) -> None:
        self.method_log[req.uid].append((self.tick_count, req.phase, method))

    def _method_name(self, gvr_row: bool) -> str:
        return "gvr" if gvr_row else self._cold_method

    def _next_token(self, req: Request, argmax_tok: int, logits_row) -> int:
        """Greedy by default; temperature/top-p sampling from the request's
        own generator otherwise."""
        if req.temperature <= 0.0:
            return int(argmax_tok)
        return sampling.sample_token(logits_row, req._key,
                                     temperature=req.temperature,
                                     top_p=req.top_p)

    def _push_page_table(self) -> None:
        if self.kv is not None and self.kv.dirty:
            self.state["page_table"] = torch.as_tensor(
                self.kv.table_array()).to(self.device)
            self.kv.dirty = False

    def _copy_page(self, cow) -> None:
        """Device-side page copy backing a copy-on-write remap (in place).
        The descriptor is `(src, dst)`, or `(shard, src, dst)` with
        shard-local ids under sequence sharding, where only the rank
        holding that shard's pool copies."""
        if self.seq_shards > 1:
            shard, src, dst = cow
            if shard != self.mesh.rank:
                return
            index = (slice(None), 0)
        else:
            (src, dst), index = cow, (slice(None),)
        for key in ("k_pages", "v_pages", "idx_k_pages"):
            if key in self.state:
                arr = self.state[key][index]
                arr[:, dst] = arr[:, src]

    def _preempt_victim(self, exclude: Optional[int] = None,
                        shard: Optional[int] = None) -> Optional[int]:
        """Lowest-priority victim under page pressure: the PREFILL slot with
        the most remaining prompt tokens (ties toward the latest admission);
        if every other slot decodes, the DECODE slot with the fewest
        generated tokens. When the exhaustion names a pressured shard
        (sequence sharding), only slots holding pages in that shard are
        candidates: evicting any other frees no page where the allocation
        failed."""
        def holds(s):
            return shard is None or self.kv.pages_in_shard(s, shard) > 0
        best, best_key = None, None
        for s, req in enumerate(self.slots):
            if (req is None or req.phase != PREFILL or s == exclude
                    or not holds(s)):
                continue
            key = (len(req.prompt) - req.prefill_pos, req.admitted_at)
            if best_key is None or key > best_key:
                best, best_key = s, key
        if best is not None:
            return best
        for s, req in enumerate(self.slots):
            if (req is None or req.phase != DECODE or s == exclude
                    or not holds(s)):
                continue
            key = (-len(req.generated), req.admitted_at)
            if best_key is None or key > best_key:
                best, best_key = s, key
        return best

    def _preempt(self, victim: int) -> None:
        """Evict a slot back to the front of the queue: pages released,
        feedback poisoned, token counters rolled back (the replay
        regenerates the same tokens); its method_log entries stay."""
        req = self.slots[victim]
        self.kv.release_slot(victim)
        self.state = self.pool.evict(self.state, victim)
        self.decoded_tokens -= len(req.generated)
        self.prefill_tokens -= max(req.prefill_pos - req._skip, 0)
        req.phase, req.slot = QUEUED, None
        req.prefill_pos = 0
        req._materialized = 0
        req._skip = 0
        req.generated.clear()
        req.logits_log.clear()
        req.preemptions += 1
        self.slots[victim] = None
        self.preemptions += 1
        if self.drafter is not None:
            # stateful drafters resync from scratch on the replay
            self.drafter.release(req.uid)
        self.scheduler.requeue(req)

    def _ensure_decode_page(self, slot: int, pos: int) -> None:
        """Map (and COW-protect) the page a DECODE slot is about to write;
        pool pressure preempts the lowest-priority other slot."""
        while True:
            try:
                self.kv.ensure_mapped(slot, pos)
                cow = self.kv.ensure_writable(slot, pos)
                if cow is not None:
                    self._copy_page(cow)
                return
            except PoolExhausted as exc:
                victim = self._preempt_victim(exclude=slot, shard=exc.shard)
                if victim is None:
                    # the message names the binding pool (the sharded
                    # manager's names the shard)
                    raise RuntimeError(
                        f"page pool exhausted ({exc}) with nothing left to "
                        f"preempt: slot {slot} alone needs more pages than "
                        f"the binding pool holds — increase num_pages") from None
                self._preempt(victim)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                continue
            req = self.scheduler.peek(self.tick_count)
            if req is None:
                return
            plan = None
            if self.kv is not None:
                plan = self.kv.admit(slot, req.prompt)
                if plan is None:
                    return           # pool exhausted: stay queued, retry
            self.scheduler.take(req)
            self.state = self.pool.admit(self.state, slot,
                                         seq_len_hint=len(req.prompt))
            req._materialized = plan.materialized if plan else 0
            req._skip = plan.skip_len if plan else 0
            req.prefill_pos = req._skip
            if plan is not None and plan.skip_len:
                length = self.state["length"].clone()
                length[slot] = plan.skip_len
                self.state["length"] = length
            if req.temperature > 0.0:
                # re-created per admission: a preempted request replays the
                # same draws on its second pass
                req._key = sampling.request_key(
                    req.seed if req.seed is not None else req.uid)
            req.slot, req.phase = slot, PREFILL
            req.admitted_at = self.tick_count
            self.slots[slot] = req

    def _prefill_tick(self) -> None:
        for req in list(self.slots):
            if req is None or req.phase != PREFILL:
                continue
            chunk = req.prompt[req.prefill_pos:req.prefill_pos + self.prefill_chunk]
            self._push_page_table()
            last_logits, first_gvr = self._prefill_slot(chunk, req.slot,
                                                        req._materialized)
            # the dispatch decision is made at tick entry: log the path that
            # served the chunk's first token
            self._log(req, self._method_name(first_gvr))
            req.prefill_pos += len(chunk)
            self.prefill_tokens += len(chunk)
            if req.prefill_pos >= len(req.prompt):
                if self.kv is not None:
                    self.kv.commit_prefix(req.slot, req.prompt)
                # the last prompt token's logits yield the first generation
                req.phase = DECODE
                row = last_logits[0]
                req.generated.append(self._next_token(
                    req, int(torch.argmax(row)), row))
                if self.record_logits:
                    req.logits_log.append(row.cpu().numpy())
                self.decoded_tokens += 1
                self._maybe_finish(req.slot)

    # ---- speculative decode tick (serve.spec) ---------------------------

    def _draft_depth(self, req: Request) -> int:
        """Draft depth for one DECODE slot: the engine's depth, capped by
        the request's own, its remaining max_new budget, and 0 for sampled
        requests (greedy-only speculation)."""
        depth = (self.spec_depth if req.spec_depth is None
                 else min(req.spec_depth, self.spec_depth))
        if req.temperature > 0.0:
            depth = 0
        return min(depth, req.max_new_tokens - len(req.generated) - 1)

    def _request_draft(self, req: Request) -> List[int]:
        depth = self._draft_depth(req)
        if depth <= 0:
            return []
        return [int(t) for t in self.drafter.draft(req, depth)][:depth]

    def _collect_drafts(self, wanting: List[Tuple[int, Request]]
                        ) -> Dict[int, List[int]]:
        """Drafts for every DECODE slot: one `draft_batch` call where the
        drafter has it (ModelDrafter), else one `draft` per slot."""
        batch_fn = getattr(self.drafter, "draft_batch", None)
        if batch_fn is not None:
            pairs = [(req, self._draft_depth(req)) for _, req in wanting]
            by_uid = batch_fn(pairs)
            return {s: [int(t) for t in by_uid.get(req.uid, [])][:depth]
                    for (s, req), (_, depth) in zip(wanting, pairs)}
        return {s: self._request_draft(req) for s, req in wanting}

    def _decode_tick_spec(self) -> None:
        """Speculative `_decode_tick`: draft per slot, map the pages of
        every position to verify (pool pressure may preempt here), run one
        verify tick, append the accepted tokens, and rewind each slot's
        pages to the accepted prefix."""
        d1 = self.spec_depth + 1
        wanting = [(s, req) for s, req in enumerate(self.slots)
                   if req is not None and req.phase == DECODE]
        drafts = self._collect_drafts(wanting)
        for s in list(drafts):
            req = self.slots[s]
            if req is None or req.phase != DECODE:
                drafts.pop(s)          # preempted while mapping another slot
                continue
            pos0 = len(req.prompt) + len(req.generated) - 1
            for pos in range(pos0, pos0 + len(drafts[s]) + 1):
                self._ensure_decode_page(s, pos)
        self._push_page_table()
        active_np = np.array([r is not None and r.phase == DECODE
                              for r in self.slots])
        if not active_np.any():
            return
        tokens = np.zeros((self.num_slots, d1), np.int32)
        draft_len = np.zeros((self.num_slots,), np.int32)
        max_accept = np.zeros((self.num_slots,), np.int32)
        for s, req in enumerate(self.slots):
            if not active_np[s]:
                continue
            draft = drafts.get(s, [])
            tokens[s, 0] = req.generated[-1]
            tokens[s, 1:1 + len(draft)] = draft
            draft_len[s] = len(draft)
            max_accept[s] = req.max_new_tokens - len(req.generated) - 1
        dev = self.device
        active = torch.as_tensor(active_np).to(dev)
        mwp = torch.where(active, 0, PAGED_NEVER_WRITE).to(torch.int32)
        kw = dict(draft_len=torch.as_tensor(draft_len).to(dev),
                  max_accept=torch.as_tensor(max_accept).to(dev),
                  eos_id=self.eos_id if self.eos_id is not None else -1,
                  min_write_pos=mwp, verify_kernel=self.verify_kernel)
        if self.seq_shards > 1:
            out = self.model.serve_step_sp_spec_paged(
                self.params, self.state, torch.as_tensor(tokens).to(dev),
                mesh=self.mesh, **kw)
        else:
            out = self.model.serve_step_spec_paged(
                self.params, self.state, torch.as_tensor(tokens).to(dev),
                paged_attn=self.paged_attn,
                gather_granularity=self.gather_granularity, **kw)
        out_tokens, accept_len, logits_all, sel_pos, new_state = out
        self.state = self._merge_active(new_state, self.state, active)
        # one device-to-host copy per tick: tokens, accept lengths, layer-0
        # GVR path per position
        host = torch.cat([out_tokens, accept_len[:, None], sel_pos.int()],
                         dim=1).cpu().numpy()
        out_np, accept_np, sel_np = host[:, :d1], host[:, d1], host[:, d1 + 1:]
        logits_np = logits_all.cpu().numpy() if self.record_logits else None
        for s, req in enumerate(self.slots):
            if not active_np[s]:
                continue
            a, dlen = int(accept_np[s]), int(draft_len[s])
            for p in range(a + 1):
                # accepted positions stand one to one for non-spec ticks
                self._log(req, self._method_name(bool(sel_np[s, p])))
                if p == 0:
                    # sampled requests (always depth 0) draw from position 0
                    tok = self._next_token(req, int(out_np[s, 0]),
                                           logits_all[s, 0])
                else:
                    tok = int(out_np[s, p])
                req.generated.append(tok)
                if self.record_logits:
                    req.logits_log.append(logits_np[s, p].copy())
                self.decoded_tokens += 1
            # telemetry over every executed position, accepted or wasted
            if dlen > 0:
                self.spec_ticks += 1
                self.spec_drafted += dlen
                self.spec_accepted += a
            for j in range(dlen + 1):
                self._spec_pos_total[j] += 1
                self._spec_pos_hits[j] += bool(sel_np[s, j])
            # page rewind to the accepted prefix
            self.kv.rewind_slot(s, len(req.prompt) + len(req.generated) - 1)
            self._maybe_finish(s)

    def _decode_tick(self) -> None:
        if self.spec_depth > 0:
            self._decode_tick_spec()
            return
        if self.kv is not None:
            for s, req in enumerate(self.slots):
                if req is None or req.phase != DECODE:
                    continue
                self._ensure_decode_page(
                    s, len(req.prompt) + len(req.generated) - 1)
            self._push_page_table()
        active_np = np.array([r is not None and r.phase == DECODE
                              for r in self.slots])
        if not active_np.any():
            return
        tokens = np.zeros((self.num_slots,), np.int32)
        for s, req in enumerate(self.slots):
            if active_np[s]:
                tokens[s] = req.generated[-1]
        active = torch.as_tensor(active_np).to(self.device)
        mwp = torch.where(active, 0, PAGED_NEVER_WRITE).to(torch.int32)
        logits, new_state = self._step(
            self.state, torch.as_tensor(tokens).to(self.device), mwp)
        self.state = self._merge_active(new_state, self.state, active)
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy()
        sel_gvr = (self.state["sel_gvr"][0].cpu().numpy()
                   if "sel_gvr" in self.state
                   else np.zeros((self.num_slots,), bool))
        for s, req in enumerate(self.slots):
            if not active_np[s]:
                continue
            self._log(req, self._method_name(bool(sel_gvr[s])))
            req.generated.append(self._next_token(req, int(next_tok[s]),
                                                  logits[s]))
            if self.record_logits:
                req.logits_log.append(logits[s].cpu().numpy())
            self.decoded_tokens += 1
            self._maybe_finish(s)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slots[slot]
        if (len(req.generated) >= req.max_new_tokens
                or (self.eos_id is not None
                    and req.generated[-1] == self.eos_id)):
            req.phase = DONE
            req.finished_at = self.tick_count
            if self.kv is not None:
                self.kv.release_slot(slot)
            self.state = self.pool.evict(self.state, slot)
            self.slots[slot] = None
            if self.drafter is not None:
                self.drafter.release(req.uid)
            self.completed.append(req)

    def tick(self) -> None:
        """One engine tick: admit → chunked prefill → pool decode → retire."""
        self._admit()
        self.peak_occupancy = max(self.peak_occupancy,
                                  sum(r is not None for r in self.slots))
        self._prefill_tick()
        self._decode_tick()
        if self.kv is not None:
            self.peak_pages_in_use = max(self.peak_pages_in_use,
                                         self.kv.pages_in_use)
            self.peak_pool_util = max(self.peak_pool_util,
                                      self.kv.hot_pool_utilization)
        self.tick_count += 1

    def idle(self) -> bool:
        return (all(r is None for r in self.slots)
                and self.scheduler.pending() == 0)

    def run(self, requests=None, max_ticks: int = 10_000) -> EngineReport:
        """Drive until drained (or `max_ticks`). Returns throughput and
        selector-path telemetry; per-request outputs live on the requests.
        The wall clock ends after the device has finished."""
        for r in (requests or []):
            self.submit(r)
        t0 = time.perf_counter()
        self.peak_occupancy = sum(r is not None for r in self.slots)
        self.peak_pages_in_use = (self.kv.pages_in_use
                                  if self.kv is not None else 0)
        self.peak_pool_util = (self.kv.hot_pool_utilization
                               if self.kv is not None else 0.0)
        start_tick = self.tick_count
        start_decoded = self.decoded_tokens
        start_prefill = self.prefill_tokens
        start_completed = len(self.completed)
        start_preempt = self.preemptions
        start_skipped = self.kv.skipped_tokens if self.kv is not None else 0
        start_spec = (self.spec_ticks, self.spec_drafted, self.spec_accepted)
        start_pos_hits = self._spec_pos_hits.copy()
        start_pos_total = self._spec_pos_total.copy()
        while not self.idle() and self.tick_count - start_tick < max_ticks:
            self.tick()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        combined: Dict[str, int] = {}
        by_phase: Dict[str, Dict[str, int]] = {PREFILL: {}, DECODE: {}}
        for entries in self.method_log.values():
            for tick, phase, method in entries:
                if tick >= start_tick:
                    combined[method] = combined.get(method, 0) + 1
                    bucket = by_phase.setdefault(phase, {})
                    bucket[method] = bucket.get(method, 0) + 1
        pos_hits = self._spec_pos_hits - start_pos_hits
        pos_total = self._spec_pos_total - start_pos_total
        return EngineReport(
            ticks=self.tick_count - start_tick, wall_s=wall,
            decoded_tokens=self.decoded_tokens - start_decoded,
            prefill_tokens=self.prefill_tokens - start_prefill,
            completed=len(self.completed) - start_completed,
            method_counts=combined,
            prefill_method_counts=by_phase[PREFILL],
            decode_method_counts=by_phase[DECODE],
            preemptions=self.preemptions - start_preempt,
            prefix_hit_tokens=(self.kv.skipped_tokens - start_skipped
                               if self.kv is not None else 0),
            peak_page_utilization=self.peak_pool_util,
            spec_ticks=self.spec_ticks - start_spec[0],
            spec_drafted=self.spec_drafted - start_spec[1],
            spec_accepted=self.spec_accepted - start_spec[2],
            gvr_hit_rate_by_draft_pos=[
                float(h) / float(t) if t else 0.0
                for h, t in zip(pos_hits, pos_total)])
