"""Bytes and operations of the served model's work in one engine tick.

A tick runs one decode step over the pool and, for each request admitted in
it, a step of one row; a step row is (its new length). The least work the
tick's inputs need, from the configuration file's `model` block:

* every weight read once a tick: attention, norms, indexer, the feed-forward
  and the output head, and the embedding rows of the tick's tokens;
* a row, a layer: its indexer-K rows over its own length, its min(K, L)
  selected K/V rows (all L rows where DSA is off), its new K, V and
  indexer-K rows written;
* a row: its f32 logits written.

Operations count 2 a multiply-add: the projections and the feed-forward a
token, Eq. 1 over the row's
length (2 Hi di L), attention over the selected rows (4 H hd min(K, L)),
and the output head.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple


def _layer_weight_bytes(m: Dict) -> float:
    d, h, kvh, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    nb = (d * (h + 2 * kvh) * hd + h * hd * d) * 2 + 2 * d * 4
    dsa = m["dsa"]
    if dsa["enabled"]:
        hi, di = dsa["indexer_heads"], dsa["indexer_dim"]
        nb += (d * hi * di + d * di) * 2 + hi * 4
    return float(nb + 3 * d * m["d_ff"] * 2)


def _token_layer_flops(m: Dict) -> float:
    d, h, kvh, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    fl = 2 * (d * (h + 2 * kvh) * hd + h * hd * d)
    dsa = m["dsa"]
    if dsa["enabled"]:
        fl += 2 * d * (dsa["indexer_heads"] * dsa["indexer_dim"]
                       + dsa["indexer_dim"])
    return float(fl + 2 * 3 * d * m["d_ff"])


def tick(m: Dict, rows: Sequence[int], *, dsa_on: bool) -> Tuple[float, float]:
    """(bytes, flops) of one tick whose steps' rows have the new lengths
    `rows` (every row of every step of the tick, admissions included)."""
    d, hd, kvh, h = m["d_model"], m["head_dim"], m["n_kv_heads"], m["n_heads"]
    layers, vocab = m["n_layers"], m["vocab"]
    dsa = m["dsa"]
    if m.get("moe"):
        raise ValueError("the counts cover dense feed-forward layers only")
    t = len(rows)
    nbytes = layers * _layer_weight_bytes(m) + d * vocab * 2 + d * 4
    flops = t * (layers * _token_layer_flops(m) + 2 * d * vocab)
    nbytes += t * (d * 2 + vocab * 4)
    for n in rows:
        n = int(n)
        if dsa_on:
            hi, di, k = dsa["indexer_heads"], dsa["indexer_dim"], dsa["k"]
            sel = min(k, n)
            per_layer_b = n * di * 2 + sel * kvh * hd * 2 * 2
            per_layer_f = 2 * hi * di * n + 4 * h * hd * sel
            new = (2 * kvh * hd + di) * 2
        else:
            per_layer_b = n * kvh * hd * 2 * 2
            per_layer_f = 4 * h * hd * n
            new = 2 * kvh * hd * 2
        nbytes += layers * (per_layer_b + new)
        flops += layers * per_layer_f
    return float(nbytes), float(flops)


def window(m: Dict, ticks: Iterable[Sequence[int]], *, dsa_on: bool,
           bound) -> float:
    """The least seconds the window's ticks need: the sum over ticks of the
    larger of bytes over the memory's rate and operations over the peak
    (`bound(bytes, flops)`)."""
    return sum(bound(*tick(m, rows, dsa_on=dsa_on)) for rows in ticks if rows)
