"""The served path: `serve.DecodeEngine` (paged layout, fused attention,
prefix caching, FIFO) decoding for a closed loop of clients over long
documents whose caches were restored in set-up.

Set-up draws the weights and, for each document, its token ids and its
cache rows at every layer (indexer-K rows N(0, 1) times a per-position
scale exp(sigma eps), K and V rows N(0, 1)), and hands them to the
engine through its page manager alone: `admit` plans the document's pages,
the rows are written there, `commit_prefix` registers them as a cached
prefix and `release_slot` leaves them to the cache (how a decode node takes
a KV cache from a store). A request is a document and one new token: it
admits through the engine's own prefix hit, streams its one token, and
decodes greedily for its drawn number of tokens. Each of the clients sends
its next request as soon as its last one is done.

The window times `engine.tick()` calls for the given seconds: the decode
rate is the tokens the ticks delivered over the window's seconds.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from gvr_bench.harness import model as hm
from gvr_bench.harness import seeds
from gvr_bench.harness.trace import capture, span


def doc_lengths(t: Dict) -> List[int]:
    """The documents' lengths: the same set for every seed, the `docs`
    quantiles of a log-uniform law on [doc_low, doc_high], each rounded
    down to a multiple of `doc_multiple`."""
    lo, hi, n, q = t["doc_low"], t["doc_high"], t["docs"], t["doc_multiple"]
    return [int(math.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                         * (i + 0.5) / n)) // q * q for i in range(n)]


def decks(t: Dict, seed: int):
    """The requests' documents and output lengths, in turn: a deck of
    `deck` entries, each document equally often and the output lengths
    evenly spread over [out_low, out_high], shuffled by the seed."""
    n, r = t["deck"], seeds.rng(seed, "engine", "deck")
    docs = np.arange(n) % t["docs"]
    outs = np.round(t["out_low"] + (t["out_high"] - t["out_low"])
                    * (np.arange(n) + 0.5) / n).astype(int)
    return r.permutation(docs).tolist(), r.permutation(outs).tolist()


class Driver:
    # K rows scaled as the indexer keys are: a knob of the readings, which
    # look at what bfloat16 attention does on such rows; the cells keep it off
    scale_k = False

    def __init__(self, ctx):
        self.ctx = ctx
        self.outstanding: Dict[int, object] = {}
        self.meta: Dict[int, Dict] = {}
        self.done: List = []
        self.uid = 0

    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models.api import build_model
        from repro_torch.serve import DecodeEngine
        ctx, t = self.ctx, self.ctx.traffic
        cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
        m = ctx.conf["model"]
        self.m = m
        self.dtype = hm.DTYPES[m["dtype"]]
        self.weights = hm.draw_weights(cfg, ctx.conf, seed, dev)
        self.eng = DecodeEngine(
            build_model(cfg, device=dev), self.weights,
            num_slots=t["slots"], max_len=t["max_len"],
            prefill_chunk=t["prefill_chunk"], scheduler="fifo",
            kv_layout="paged", page_size=t["page_size"],
            prefix_caching=True, paged_attn="fused",
            gather_granularity="token")
        self.ctx.record.dsa_on = bool(cfg.dsa.enabled
                                      and t["max_len"] > cfg.dsa.min_n)
        self.lengths = doc_lengths(t)
        tok_rng = seeds.rng(seed, "engine", "tokens")
        self.docs = [tok_rng.integers(0, cfg.vocab, n).astype(np.int32)
                     for n in self.lengths]
        for d in range(t["docs"]):
            self._restore(d)
        self.deck_docs, self.deck_outs = decks(t, seed)
        self.new_tok = seeds.rng(seed, "engine", "new")
        for _ in range(t["clients"]):
            self._submit()
        for _ in range(t["warmup_ticks"]):
            self._tick()

    def _rows(self, d: int, layer: int):
        """Document d's (K, V, indexer-K) rows at one layer: the indexer
        keys carry the document's per-position scale, K and V are N(0, 1)
        (with `scale_k` K carries the scale too: readings only)."""
        m, seed, dev = self.m, self.ctx.seed, self.ctx.device
        n = self.lengths[d]
        scale = hm.doc_scale(seed, d, n, self.ctx.traffic["sigma"], dev)
        kvh, hd = m["n_kv_heads"], m["head_dim"]
        k = hm.doc_rows(seed, d, layer, "k", (kvh, hd), n,
                        scale if self.scale_k else None, self.dtype, dev)
        v = hm.doc_rows(seed, d, layer, "v", (kvh, hd), n, None, self.dtype, dev)
        di = m["dsa"]["indexer_dim"]
        ik = hm.doc_rows(seed, d, layer, "idx_k", (di,), n, scale, self.dtype,
                         dev)
        return k, v, ik

    def _restore(self, d: int) -> None:
        """Document d's rows into the engine's pools, through its page
        manager, registered as a cached prefix."""
        eng, toks = self.eng, self.docs[d]
        ps = self.ctx.traffic["page_size"]
        if eng.kv.admit(0, toks) is None:
            raise RuntimeError(f"document {d} does not fit the page pool")
        pages = torch.as_tensor(eng.kv.slot_pages(0), device=self.ctx.device)
        npg = len(toks) // ps
        for layer in range(self.m["n_layers"]):
            k, v, ik = self._rows(d, layer)
            eng.state["k_pages"][layer][pages] = k.view((npg, ps) + k.shape[1:])
            eng.state["v_pages"][layer][pages] = v.view((npg, ps) + v.shape[1:])
            if "idx_k_pages" in eng.state:
                eng.state["idx_k_pages"][layer][pages] = ik.view(npg, ps, -1)
        eng.kv.commit_prefix(0, toks)
        eng.kv.release_slot(0)

    def _submit(self) -> None:
        from repro_torch.serve import Request
        i = self.uid
        self.uid += 1
        d = self.deck_docs[i % len(self.deck_docs)]
        out = self.deck_outs[i % len(self.deck_outs)]
        tok = int(self.new_tok.integers(0, self.ctx.cfg.vocab))
        req = Request(uid=i, prompt=np.append(self.docs[d], np.int32(tok)),
                      max_new_tokens=int(out))
        self.eng.submit(req)
        self.outstanding[i] = req
        self.meta[i] = {"doc": d, "times": []}

    def _tick(self, launches: List = None) -> List[int]:
        """One engine tick and the clients' turn after it. Returns the new
        lengths of every step row the tick ran."""
        from repro_torch.serve.scheduler import DONE
        before = {u: len(r.generated) for u, r in self.outstanding.items()}
        with span("harness.tick"):
            self.eng.tick()
        now = time.perf_counter()
        with span("harness.clients"):
            prefill, decode = [], []
            for u, req in list(self.outstanding.items()):
                n0, n1 = before[u], len(req.generated)
                plen = len(req.prompt)
                for j in range(n0, n1):
                    (prefill if j == 0 else decode).append(plen + j)
                    self.meta[u]["times"].append(now)
                if req.phase == DONE:
                    del self.outstanding[u]
                    self.done.append(req)
                    self._submit()
        if launches is not None:
            self._launches(launches, prefill, decode)
        return prefill + decode

    def _launches(self, out: List, prefill: List[int], decode: List[int]) -> None:
        """The B2 scoring and B1 launches of one tick, each with its rows'
        real lengths: a batch-1 step per admission, one step over the
        decoding slots."""
        dsa = self.m["dsa"]
        k = min(dsa["k"], self.ctx.traffic["max_len"])
        steps = [[n] for n in prefill] + ([decode] if decode else [])
        for lens in steps:
            for _ in range(self.m["n_layers"]):
                out.append({"kind": "b2_scoring", "lengths": lens,
                            "heads": dsa["indexer_heads"],
                            "dim": dsa["indexer_dim"],
                            "page_size": self.ctx.traffic["page_size"]})
                out.append({"kind": "b1", "lengths": lens, "m": k, "k": k})

    # ---- the timed path ---------------------------------------------------
    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def window(self, seconds: float) -> None:
        rec = self.ctx.record
        self._sync()
        first_done = len(self.done)
        for meta in self.meta.values():
            meta["times"].clear()
        t0 = time.perf_counter()
        marks, tokens = [], 0
        while True:
            rec.ticks.append(self._tick())
            tokens += len(rec.ticks[-1])
            elapsed = time.perf_counter() - t0
            if elapsed >= 5.0 * (len(marks) + 1):
                marks.append(tokens)
            if elapsed >= seconds:
                break
        self._sync()
        rec.window_s = time.perf_counter() - t0
        self.t_close = time.perf_counter()
        for meta in self.meta.values():
            times = meta["times"]
            rec.gaps_ms.extend((b - a) * 1e3 for a, b in zip(times, times[1:]))
        self.checkable = list(self.done)
        self.stale = self._stale_slots()
        rec.counters.update(
            decoded_tokens=sum(len(r) for r in rec.ticks),
            ticks=len(rec.ticks), completed=len(self.done) - first_done,
            preemptions=self.eng.preemptions,
            tokens_by_5s=[b - a for a, b in zip([0] + marks, marks)])
        rec.attempted = len(self.done) - first_done + len(self.outstanding)

    def _stale_slots(self) -> int:
        """Decoding slots whose cache length in the engine's state is not
        the request's prompt and served tokens less one (the position of
        the last token fed): a step that does not advance its state."""
        from repro_torch.serve.scheduler import DECODE
        length = self.eng.state["length"].cpu().tolist()
        return sum(int(length[s] != len(r.prompt) + len(r.generated) - 1)
                   for s, r in enumerate(self.eng.slots)
                   if r is not None and r.phase == DECODE)

    def traced(self) -> None:
        rec, t = self.ctx.record, self.ctx.traffic
        sink: Dict = {}
        with capture(sink, self.ctx.device):
            for _ in range(t["trace_ticks"]):
                self._tick(launches=rec.launches)
        rec.trace = sink["trace"]

    # ---- after the window ---------------------------------------------------
    def release(self) -> None:
        """The program's state: the engine, its pools and its page manager.
        The weights are the benchmark's, which the reference reads."""
        self.eng = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List:
        """The requests checked, out of those finished by the window's
        close: the one with the most served tokens, then one from each
        other slot in a seeded order (a request drawn from the seed among
        that slot's), up to the mix's `check_requests`."""
        reqs = sorted(self.checkable, key=lambda r: r.uid)
        if not reqs:
            return []
        r = seeds.rng(self.ctx.seed, "engine", "check")
        longest = max(reqs, key=lambda q: (len(q.generated), -q.uid))
        picked = [longest]
        slots = sorted({q.slot for q in reqs} - {longest.slot})
        for s in r.permutation(slots).tolist():
            if len(picked) >= self.ctx.traffic["check_requests"]:
                break
            mine = [q for q in reqs if q.slot == s]
            picked.append(mine[int(r.integers(len(mine)))])
        return picked

    def gaps(self, req, low=None) -> torch.Tensor:
        """The reference's gap at every served token of `req`; with `low`
        ("fp8": the control; "bf16": a witness) the gap of the token that
        the reference computed in that precision puts first instead."""
        from gvr_bench.reference import compare, model as ref_model
        dev = self.ctx.device
        d = self.meta[req.uid]["doc"]
        fed = torch.as_tensor(np.append(req.prompt[-1:], req.generated[:-1]),
                              device=dev)
        served = torch.as_tensor(np.asarray(req.generated), device=dev)
        kw = dict(dsa_on=self.ctx.record.dsa_on, eps=self.m["norm_eps"])
        rows = lambda layer: self._rows(d, layer)           # noqa: E731
        ref = ref_model.logits(self.weights, self.m, fed, len(req.prompt) - 1,
                               rows, **kw)
        if low:
            ctl = ref_model.logits(self.weights, self.m, fed,
                                   len(req.prompt) - 1, rows, low=low, **kw)
            served = ctl.argmax(dim=-1)
        return compare.token_gaps(ref, served)

    def check(self, low=None) -> Dict[str, float]:
        """The numbers the cell's limits may hold: the widest gap of a
        served token below the reference's best (`logit_gap`), the largest
        mean gap of one checked request (`mean_gap`), and the decoding
        slots whose state did not advance (`stale_slots`); besides, for the
        look, the mean gap, the share of tokens off the reference's best
        and the tokens checked. With `low` the reference computed in that
        precision takes the program's place (`gaps`)."""
        from gvr_bench.reference import ops
        ops.full_precision()
        limits = self.ctx.workload["limits"]
        picked = self.sample()
        per_req = [self.gaps(req, low=low) for req in picked]
        if low is None:
            rec = self.ctx.record
            rec.counters["checked_requests"] = len(picked)
            rec.counters["checked_tokens"] = sum(g.numel() for g in per_req)
        if not per_req:
            return {"logit_gap": float("inf"), "mean_gap": float("inf"),
                    "stale_slots": float(self.stale)}
        every = torch.cat(per_req)
        if low is None:
            rec.failed = sum(
                float(g.max()) > limits.get("logit_gap", float("inf"))
                or float(g.mean()) > limits.get("mean_gap", float("inf"))
                for g in per_req)
        return {"logit_gap": float(every.max()),
                "mean_gap": max(float(g.mean()) for g in per_req),
                "stale_slots": float(self.stale),
                "overall_mean": float(every.mean()),
                "share_off": float((every > 0).float().mean()),
                "tokens": float(every.numel())}
