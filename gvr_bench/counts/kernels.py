"""Bytes and operations of the DSA selection kernels of one launch.

B2's scoring launch (`csrc/indexer_scores.cu`, Eq. 1 through the block
table) and B1 (`csrc/gvr_topk.cu`, the exact Top-K of the score row),
each over the rows' real lengths: a row's positions past its length, the
padding up to the pool's width, are no input the answer needs.

* B2 scoring reads each row's query (heads x dim, bf16), its keys on the
  pages up to its length (bf16), its block-table entries for those pages
  and its length (int32), and the head weights (f32); it writes the f32
  score of each position up to the row's length. 2 x heads x dim
  operations a scored position.
* B1 reads each row's scores up to its length (f32) and its M previous
  Top-K indices (int32), and writes K values (f32), K indices (int32) and
  8 f32 statistics a row.

`b2` is the two launches as PERF.md's kernel table bounds B2: the scoring's
inputs and B1's outputs, the score row between them left out.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def _pages(lengths: Sequence[int], page_size: int) -> int:
    return sum(-(-int(n) // page_size) for n in lengths)


def _scoring_inputs(lengths: Sequence[int], heads: int, dim: int,
                    page_size: int) -> int:
    """Bytes of the scoring's inputs: queries, keys, weights, table
    entries and lengths."""
    rows, pages = len(lengths), _pages(lengths, page_size)
    return (rows * heads * dim * 2 + pages * page_size * dim * 2 + heads * 4
            + pages * 4 + rows * 4)


def _topk_outputs(rows: int, k: int) -> int:
    return rows * k * 8 + rows * 32


def b2_scoring(lengths: Sequence[int], *, heads: int, dim: int,
               page_size: int) -> Tuple[float, float]:
    """(bytes, flops) of one scoring launch over rows of `lengths`."""
    total = sum(int(x) for x in lengths)
    nbytes = _scoring_inputs(lengths, heads, dim, page_size) + total * 4
    return float(nbytes), float(2 * heads * dim * total)


def b1(lengths: Sequence[int], *, m: int, k: int) -> Tuple[float, float]:
    """(bytes, flops) of one B1 launch over score rows of `lengths`, M
    predictions a row, K outputs a row."""
    rows, total = len(lengths), sum(int(x) for x in lengths)
    return float(total * 4 + rows * m * 4 + _topk_outputs(rows, k)), 0.0


def b2(lengths: Sequence[int], *, heads: int, dim: int, page_size: int,
       k: int) -> Tuple[float, float]:
    """(bytes, flops) of B2 = scoring then B1, as the kernel table bounds
    it: the scoring's inputs, the previous Top-K read, the K values and
    indices and the statistics written."""
    rows, total = len(lengths), sum(int(x) for x in lengths)
    nbytes = (_scoring_inputs(lengths, heads, dim, page_size) + rows * k * 4
              + _topk_outputs(rows, k))
    return float(nbytes), float(2 * heads * dim * total)
