"""The DSA selection layer alone: `sparse.dsa.dsa_select_paged` (B2's
scoring through the block table, then B1's GVR Top-K on the card), called
once for each of the model's indexers a decode step, over the rows of a
decode batch at long contexts, dispatched ahead: the harness makes no
host synchronisation of its own until the window closes.

Set-up draws the indexers' weights and each row's indexer keys (a restored
document: N(0, 1) rows times a per-position scale exp(sigma eps)) into one
paged pool a layer, behind a shuffled block table, and a bank of
`input_bank` steps' inputs: the rows' hidden inputs and one new key a row
and layer. Step s takes the bank's entry s mod `input_bank`; it writes the
new keys at the rows' lengths (one write for every layer) and, per layer,
selects over the new lengths, warm-started from that layer's previous
Top-K (cold on the first step), as a decode step would. Every per-layer
view is made in set-up, so the window's host work is the selection's own
but for that write and the lengths' advance. The window counts steps;
`select_us` is its seconds over steps x layers.
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


def _hit_ratio(idx_t: torch.Tensor, idx_tm1: torch.Tensor, n: int) -> torch.Tensor:
    """Share of each row's Top-K found in its previous Top-K (a copy of
    the port's `core.temporal.hit_ratio`): (R,) float32."""
    a = idx_t.clamp(0, n - 1).long()
    b = idx_tm1.clamp(0, n - 1).long()
    member = torch.zeros((b.shape[0], n), dtype=torch.bool, device=b.device)
    member.scatter_(1, b, True)
    return member.gather(1, a).float().mean(-1)


def start_lengths(traffic: Dict, seed: int) -> List[int]:
    """The rows' first lengths: the same log-spaced set for every seed
    (the mix's `rows` quantiles of a log-uniform law), in a seeded order."""
    lo, hi, r = traffic["start_low"], traffic["start_high"], traffic["rows"]
    vals = [int(math.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                         * (i + 0.5) / r)) for i in range(r)]
    order = seeds.rng(seed, "select", "order").permutation(r)
    return [vals[i] for i in order]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.samples: List[Dict] = []

    # ---- set-up ----------------------------------------------------------
    def setup(self) -> None:
        ctx, t = self.ctx, self.ctx.traffic
        cfg, dev, seed = ctx.cfg, ctx.device, ctx.seed
        m = ctx.conf["model"]
        dsa = m["dsa"]
        self.layers = cfg.n_layers
        self.rows = t["rows"]
        self.cap = t["capacity"]
        self.ps = t["page_size"]
        self.k = dsa["k"]
        self.heads, self.dim = dsa["indexer_heads"], dsa["indexer_dim"]
        self.sigma = float(t["sigma"])
        mp = self.cap // self.ps
        pages = self.rows * mp
        dtype = hm.DTYPES[m["dtype"]]
        w = hm.draw_weights(cfg, ctx.conf, seed, dev, only="layers/indexer")
        self.indexer = w["layers"]["indexer"]
        g = seeds.generator(seed, dev, "select", "table")
        self.table = torch.randperm(pages, generator=g, device=dev).int() \
            .reshape(self.rows, mp).contiguous()
        self.pools = torch.zeros((self.layers, pages + 1, self.ps, self.dim),
                                 dtype=dtype, device=dev)
        self.len_host = np.array(start_lengths(t, seed), np.int64)
        for r, n in enumerate(self.len_host.tolist()):
            scale = hm.doc_scale(seed, r, n, self.sigma, dev, tag="select")
            npg = -(-n // self.ps)
            pids = self.table[r, :npg].long()
            for layer in range(self.layers):
                rows = hm.doc_rows(seed, r, layer, "idx_k", (self.dim,), n,
                                   scale, dtype, dev, tag="select")
                buf = torch.zeros((npg * self.ps, self.dim), dtype=dtype,
                                  device=dev)
                buf[:n] = rows
                self.pools[layer][pids] = buf.view(npg, self.ps, self.dim)
        self.lengths = torch.as_tensor(self.len_host, dtype=torch.int32,
                                       device=dev)
        # the even-spacing seed over each row, invalid until the first step
        self.prev = [torch.stack([
            torch.linspace(0, n - 1, self.k, device=dev).int()
            for n in self.len_host.tolist()]).contiguous()
            for _ in range(self.layers)]
        self.valid = torch.zeros((self.rows,), dtype=torch.bool, device=dev)
        self.dtype = dtype
        self._views()
        self._bank(seeds.generator(seed, dev, "select", "steps"),
                   t["input_bank"])
        self.steps = 0
        for _ in range(t["warmup_steps"]):
            self.step()

    def _views(self) -> None:
        """Each layer's pool and indexer weights, as the calls take them."""
        self.layer_pools = list(self.pools.unbind(0))
        self.layer_ip = [{k: v[layer] for k, v in self.indexer.items()}
                         for layer in range(self.layers)]

    def _bank(self, gen: torch.Generator, size: int) -> None:
        """`size` steps' inputs, drawn in three calls: hidden rows
        (layers x rows x d_model) and new keys (layers x rows x dim), the
        keys scaled a row by exp(sigma eps) as a restored row is."""
        dev, d = self.ctx.device, self.ctx.cfg.d_model
        x = torch.randn((size, self.layers, self.rows, d), generator=gen,
                        device=dev, dtype=self.dtype)
        eps = torch.randn((size, 1, self.rows, 1), generator=gen, device=dev)
        newk = (torch.randn((size, self.layers, self.rows, self.dim),
                            generator=gen, device=dev)
                * torch.exp(self.sigma * eps)).to(self.dtype)
        self.bank_x = [list(step.unbind(0)) for step in x.unbind(0)]
        self.bank_k = list(newk.unbind(0))

    # ---- the timed path ---------------------------------------------------
    def step(self, save_layer: int = -1, counters: Dict = None) -> None:
        """One decode step of selection over every layer."""
        from repro_torch.sparse.dsa import dsa_select_paged
        cfg = self.ctx.cfg
        if int(self.len_host.max()) >= self.cap:
            raise RuntimeError(f"a row reached its capacity of {self.cap} "
                               f"positions: the mix cannot hold this window")
        b = self.steps % len(self.bank_k)
        xs = self.bank_x[b]
        pos = self.lengths.long()
        dest = self.table.gather(1, (pos // self.ps)[:, None])[:, 0].long()
        self.pools[:, dest, pos % self.ps] = self.bank_k[b]
        new_len = self.lengths + 1
        for layer in range(self.layers):
            prev = self.prev[layer]
            sel = dsa_select_paged(
                self.layer_ip[layer], xs[layer], self.layer_pools[layer],
                self.table, prev, new_len, k=self.k,
                heads=self.heads, dim=self.dim, rope_base=cfg.rope_base,
                selector=cfg.dsa.selector, prev_valid=self.valid,
                max_candidates=cfg.dsa.max_candidates,
                gate_max_n=cfg.dsa.gate_max_n, min_n=cfg.dsa.min_n,
                swa_window=cfg.swa_window)
            self.prev[layer] = sel.indices
            if layer == save_layer:
                self.samples.append({"step": self.steps, "layer": layer,
                                     "x": xs[layer], "lengths": new_len,
                                     "len_host": (self.len_host + 1).tolist(),
                                     "idx": sel.indices, "vals": sel.values})
            if counters is not None:
                counters["passes"] += (sel.secant_iters.float() + 1).sum()
                counters["hits"] += _hit_ratio(sel.indices, prev, self.cap).sum()
        if not self.steps:
            self.valid = torch.ones_like(self.valid)
        self.lengths = new_len
        self.len_host = self.len_host + 1
        self.steps += 1

    def _save_plan(self) -> Dict[int, int]:
        """Steps whose selection of one layer is kept for the check: a
        seeded spread over the window, and the last step."""
        rng = seeds.rng(self.ctx.seed, "select", "check")
        first = self.steps
        marks = [first, first + 1] + [first + int(v) for v in
                                      np.geomspace(3, 4000, 8)]
        return {s: int(rng.integers(self.layers)) for s in marks}

    def window(self, seconds: float) -> None:
        rec = self.ctx.record
        plan = self._save_plan()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        first = self.steps
        t0 = time.perf_counter()
        marks = []
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= 5.0 * (len(marks) + 1):
                marks.append(self.steps - first)
            last = elapsed >= seconds
            layer = plan.get(self.steps, -1)
            if last and layer < 0:
                layer = int(seeds.rng(self.ctx.seed, "select", "last")
                            .integers(self.layers))
            self.step(save_layer=layer)
            if last:
                break
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        rec.window_s = time.perf_counter() - t0
        steps = self.steps - first
        rec.counters.update(steps=steps, layers=self.layers, rows=self.rows,
                            steps_by_5s=[b - a for a, b in
                                         zip([0] + marks, marks)])
        rec.attempted = steps * self.layers

    def traced(self) -> None:
        rec, t = self.ctx.record, self.ctx.traffic
        sink: Dict = {}
        m = self.ctx.conf["model"]["dsa"]
        with capture(sink, self.ctx.device):
            for _ in range(t["trace_steps"]):
                lens = (self.len_host + 1).tolist()
                with span("harness.select_step"):
                    self.step()
                for _ in range(self.layers):
                    rec.launches.append({
                        "kind": "b2_scoring", "lengths": lens,
                        "heads": m["indexer_heads"], "dim": m["indexer_dim"],
                        "page_size": self.ps})
                    rec.launches.append({"kind": "b1", "lengths": lens,
                                         "m": self.k, "k": self.k})
        rec.trace = sink["trace"]
        dev = self.ctx.device
        counters = {"passes": torch.zeros((), device=dev),
                    "hits": torch.zeros((), device=dev)}
        for _ in range(t["count_steps"]):
            self.step(counters=counters)
        calls = t["count_steps"] * self.layers * self.rows
        rec.counters["gvr_passes_mean"] = float(counters["passes"]) / calls
        rec.counters["prior_hit_share"] = float(counters["hits"]) / calls

    # ---- after the window ---------------------------------------------------
    def release(self) -> None:
        """The selection's own state: the feedback chain. The pools and the
        table are the benchmark's inputs, which the reference reads."""
        self.prev = None

    def check(self, low=None) -> Dict[str, float]:
        """The worst numbers over the kept calls' rows (`compare.selection`):
        entries out of range or repeated, a selected position's shortfall
        below the K-th score, a returned value's error. With `low` ("fp8":
        the control) the reference computed in that precision takes the
        program's place: its Top-K of its own scores, judged alike."""
        from gvr_bench.reference import compare, ops, select as ref_select
        ops.full_precision()
        worst = {"bad_entries": 0.0, "shortfall": 0.0, "value_err": 0.0}
        ps, rows = self.ps, 0
        kw = dict(heads=self.heads, dim=self.dim,
                  rope_base=self.ctx.conf["model"]["rope_base"])
        for smp in self.samples:
            layer = smp["layer"]
            pool = self.layer_pools[layer]

            def keys(r, n, pool=pool):
                npg = -(-n // ps)
                return pool[self.table[r, :npg].long()].reshape(-1, self.dim)[:n]

            args = (smp["x"], self.layer_ip[layer], smp["len_host"], keys)
            ref = ref_select.scores(*args, **kw)
            lows = ref_select.scores(*args, low=low, **kw) if low else None
            for r, sc in enumerate(ref):
                if low:
                    idx = ref_select.topk(lows[r], self.k)
                    got = compare.selection(idx, lows[r][idx], sc, self.k)
                else:
                    got = compare.selection(smp["idx"][r], smp["vals"][r],
                                            sc, self.k)
                for key in worst:
                    worst[key] = max(worst[key], got[key])
                rows += 1
        if low is None:
            self.ctx.record.counters["checked_rows"] = rows
            self.ctx.record.failed = 0
        return worst
