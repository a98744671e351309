"""Pluggable drafters for the speculative serving loop (see package doc),
PyTorch port.

A drafter is HOST-side: per DECODE slot per tick the engine asks it for up
to `depth` candidate next tokens, computed from the request's own emitted
context (prompt + generated so far). Whatever it proposes, correctness is
the verify tick's job — a wrong draft costs wasted verify positions, never
wrong tokens — so drafters are free to be heuristic, stale, or plain
wrong. Determinism still matters for reproducible traces: every drafter
here is a pure function of the request's visible history (ModelDrafter's
cache included — a release + replay resyncs to the same state).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.models.transformer import PAGED_NEVER_WRITE


class Drafter:
    """Base drafter protocol.

    `draft(request, depth)` returns AT MOST `depth` proposed next tokens
    (ints); fewer (or none) is always legal — the engine just verifies a
    shorter window that tick. `release(uid)` is the lifecycle hook the
    engine calls when a request leaves its slot (retire OR preemption) so
    stateful drafters drop their per-request caches; a preempted request's
    replay then re-derives identical drafts from scratch.
    """

    def draft(self, request, depth: int) -> List[int]:
        raise NotImplementedError

    def release(self, uid: int) -> None:
        """Per-request cache drop (no-op for stateless drafters)."""


def _context(request) -> np.ndarray:
    return np.concatenate([np.asarray(request.prompt, np.int64),
                           np.asarray(request.generated, np.int64)])


class NgramDrafter(Drafter):
    """Self-drafting by suffix lookup (prompt-lookup decoding): find the
    most recent earlier occurrence of the context's trailing n-gram and
    propose the tokens that followed it. Tries the longest n first
    (`max_ngram` down to `min_ngram`) — longer matches are stronger
    evidence of a repeating span. Stateless and model-free: the draft
    source is each slot's OWN emitted tokens, the same self-speculation
    framing Vegas uses, and the natural fit for serving traces with
    repetitive structure (code, templated text, retrieval contexts).
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, request, depth: int) -> List[int]:
        ctx = _context(request)
        for n in range(min(self.max_ngram, len(ctx) - 1),
                       self.min_ngram - 1, -1):
            suffix = ctx[-n:]
            # most recent earlier occurrence of the suffix (excluding the
            # suffix itself): windows end before position len(ctx) - n
            limit = len(ctx) - n
            for start in range(limit - 1, -1, -1):
                if np.array_equal(ctx[start:start + n], suffix):
                    cont = ctx[start + n:start + n + depth]
                    if len(cont):
                        return [int(t) for t in cont]
                    break               # match flush with the suffix: try shorter n
        return []


class ReplayDrafter(Drafter):
    """Oracle replay: drafts the request's KNOWN continuation, indexed by
    how many tokens it has generated so far. With greedy verification this
    accepts 100% of drafted tokens — the speculative upper bound — which
    makes it the measurement harness for `benchmarks/run.py spec` (how
    much does a verify tick amortize when drafts are free and perfect?)
    and the full-accept leg of the rollback property tests.

    `continuations[uid]` is the request's generated-token sequence (e.g.
    recorded from a prior non-speculative run of the same trace).
    """

    def __init__(self, continuations: Dict[int, Sequence[int]]):
        self._cont = {int(u): [int(t) for t in seq]
                      for u, seq in continuations.items()}

    def draft(self, request, depth: int) -> List[int]:
        cont = self._cont.get(request.uid)
        if cont is None:
            return []
        g = len(request.generated)
        return cont[g:g + depth]


class ScriptedDrafter(Drafter):
    """Deterministic draft scripting for tests: `fn(request, depth)` is
    called verbatim. Lets a property test force arbitrary accept/reject
    traces (correct prefixes of any length, corrupted tails, empty drafts)
    and assert the engine's rollback is exact for every one of them."""

    def __init__(self, fn: Callable[..., List[int]]):
        self._fn = fn

    def draft(self, request, depth: int) -> List[int]:
        return [int(t) for t in self._fn(request, depth)][:depth]


class ModelDrafter(Drafter):
    """Classic two-model speculation: a small draft model proposes the
    continuation by greedy decode on the port's dense decode step
    (`Model.serve_step`). Given a registry name, it builds the port's own
    config and random-initialises it with the port's `init_params(seed)`
    (a torch generator: not the JAX package's weights for the same seed);
    given an explicit (model, params) pair — e.g. the target model itself,
    which makes every greedy draft match — it uses what it is given.

    Per request it keeps a batch-1 dense decode state plus a synced token
    count. Drafting feeds the unsynced context suffix through the step,
    then rolls `depth` greedy tokens forward; the draft state rolls back by
    resetting `length` (rows beyond it are dead by masking and are
    overwritten when the accepted tokens stream in).
    """

    def __init__(self, model_or_name, params=None, *, max_len: int,
                 smoke: bool = True, seed: int = 0, device=None):
        if isinstance(model_or_name, str):
            from repro_torch.configs.registry import get_config
            from repro_torch.models.api import build_model
            model = build_model(get_config(model_or_name, smoke=smoke),
                                device=device)
            params = model.init_params(seed)
        else:
            model = model_or_name
            if params is None:
                raise ValueError("explicit draft model needs its params")
        self.model = model
        self.params = params
        self.max_len = int(max_len)
        self._ctx: Dict[int, list] = {}    # uid -> [state, synced_len]

    def _tokens(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int32)).to(self.model.device)

    def _step(self, state, toks, min_write_pos=None):
        return self.model.serve_step(self.params, state, self._tokens(toks),
                                     min_write_pos=min_write_pos)

    def _depth(self, ctx: np.ndarray, depth: int) -> int:
        if len(ctx) + depth > self.max_len:
            depth = max(0, self.max_len - len(ctx))
        return depth

    def draft(self, request, depth: int) -> List[int]:
        ctx = _context(request)
        depth = self._depth(ctx, depth)
        if depth == 0:
            return []
        entry = self._ctx.get(request.uid)
        if entry is None:
            entry = [self.model.init_decode_state(1, self.max_len), 0]
        state, synced = entry
        logits = None
        for t in ctx[synced:]:
            logits, state = self._step(state, [t])
        if logits is None:                  # nothing new since last draft:
            return []                       # the last draft was fully rejected
        drafts = []
        for _ in range(depth):
            nt = int(torch.argmax(logits[0]))
            drafts.append(nt)
            logits, state = self._step(state, [nt])
        state = dict(state)
        state["length"] = torch.full_like(state["length"], len(ctx))
        self._ctx[request.uid] = [state, len(ctx)]
        return drafts

    def draft_batch(self, pairs) -> Dict[int, List[int]]:
        """Batched form of `draft` over [(request, depth), ...]: one batched
        model step per catch-up or rollout position instead of one batch-1
        step per slot and position. A row whose catch-up or rollout has
        ended is frozen: its cache write goes nowhere (`min_write_pos`
        above every position) and its per-slot leaves keep their values,
        exactly where the per-slot loop stopped stepping; rows the per-slot
        path would return early on (depth 0 after the max_len clamp, or no
        unsynced context) stay out of the batch."""
        out: Dict[int, List[int]] = {}
        rows = []                          # (uid, ctx, depth, entry)
        for req, depth in pairs:
            ctx = _context(req)
            depth = self._depth(ctx, depth)
            entry = self._ctx.get(req.uid)
            synced = entry[1] if entry is not None else 0
            if depth <= 0 or len(ctx) == synced:
                out[req.uid] = []
                continue
            rows.append((req.uid, ctx, depth, entry))
        if not rows:
            return out

        axes = self.model.state_batch_axes()
        merge_axes = self.model.state_merge_axes()
        dev = self.model.device
        states = [(e[0] if e is not None
                   else self.model.init_decode_state(1, self.max_len))
                  for _, _, _, e in rows]
        state = {key: torch.cat([s[key] for s in states], dim=axes[key])
                 for key in states[0]}

        def step(toks, take: np.ndarray):
            live = torch.as_tensor(take).to(dev)
            mwp = torch.where(live, 0, PAGED_NEVER_WRITE).to(torch.int32)
            logits, new = self._step(state, toks, mwp)
            merged = dict(new)             # the caches: written in place
            for key, ax in merge_axes.items():
                shape = [1] * new[key].dim()
                shape[ax] = len(rows)
                merged[key] = torch.where(live.reshape(shape), new[key],
                                          state[key])
            return logits, merged, live

        # catch-up: stream each row's unsynced context suffix, frozen once
        # its own suffix is exhausted
        counts = np.array([len(ctx) - (e[1] if e is not None else 0)
                           for _, ctx, _, e in rows])
        tok = np.zeros((len(rows), counts.max()), np.int32)
        for r, (_, ctx, _, e) in enumerate(rows):
            tok[r, :counts[r]] = ctx[(e[1] if e is not None else 0):]
        cur = None
        for i in range(tok.shape[1]):
            logits, state, live = step(tok[:, i], i < counts)
            cur = (logits if cur is None
                   else torch.where(live[:, None], logits, cur))

        # rollout: greedy depth steps, each row frozen past its own depth
        depths = np.array([d for _, _, d, _ in rows])
        drafts: List[List[int]] = [[] for _ in rows]
        for d in range(depths.max()):
            nt = torch.argmax(cur, dim=-1).int()
            nt_np = nt.cpu().numpy()
            for r in range(len(rows)):
                if d < depths[r]:
                    drafts[r].append(int(nt_np[r]))
            # the per-slot loop steps once per drafted token (the step after
            # the last draft included)
            logits, state, live = step(nt_np, d < depths)
            cur = torch.where(live[:, None], logits, cur)

        for r, (uid, ctx, _, _) in enumerate(rows):
            row_state = {key: arr.narrow(axes[key], r, 1).clone()
                         for key, arr in state.items()}
            row_state["length"] = torch.full_like(row_state["length"],
                                                  len(ctx))
            self._ctx[uid] = [row_state, len(ctx)]
            out[uid] = drafts[r]
        return out

    def release(self, uid: int) -> None:
        self._ctx.pop(uid, None)
