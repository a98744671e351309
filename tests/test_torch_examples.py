"""The port's four examples (`examples/torch/`) on the CPU, small.

`quickstart.run` on the JAX package's `generate_indexer_scores(PRNGKey(0),
8192, 256)` row (through numpy) gives the JAX `repro.core` functions'
secant iterations, histogram levels, snap iterations, candidates and
radix passes, and every method is exact; `serve_longcontext` completes
every request, each path R then G; `sp_gvr_500k` is exact on two gloo
ranks; `train_dsa` takes three steps of the train CLI.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch"))

import quickstart  # noqa: E402
import serve_longcontext  # noqa: E402
import sp_gvr_500k  # noqa: E402
import train_dsa  # noqa: E402


@pytest.fixture
def one_thread(monkeypatch):
    """One intra-op thread here and in child processes: the examples' small
    ops slow down many times over when the test workers' threads
    oversubscribe the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_example_quickstart_stats_equal_jax():
    n, k = 8192, 256
    scores, pre_idx = jcore.generate_indexer_scores(jax.random.PRNGKey(0), n, k)
    res = jcore.gvr_topk(scores, pre_idx, k)
    _, _, rstats = jcore.radix_select_topk(scores[None], k)
    got = quickstart.run(torch.from_numpy(np.array(scores)),
                         torch.from_numpy(np.array(pre_idx)), k, "cpu")
    assert got["secant_iters"] == int(res.stats.secant_iters)
    assert got["hist_levels"] == int(res.stats.hist_levels)
    assert got["snap_iters"] == int(res.stats.snap_iters)
    assert got["cand_count"] == int(res.stats.cand_count)
    assert got["radix_passes"] == int(rstats.passes[0])
    assert got["gvr_exact"] and got["radix_exact"] and got["kernel_exact"]


def test_example_quickstart_main_runs(capsys):
    assert quickstart.main(["--device", "cpu", "--n", "4096",
                            "--k", "128"]) == 0
    out = capsys.readouterr().out
    assert "both methods EXACT vs torch.topk" in out
    assert "kernel B1 (plain version on the CPU) EXACT" in out


def test_example_serve_longcontext_paths(one_thread):
    res = serve_longcontext.main(["--device", "cpu"])
    for layout in ("dense", "paged"):
        report, paths = res[layout]
        assert report.completed == len(paths)
        for uid, path in paths.items():
            assert path[0] == "R" and set(path[1:]) == {"G"}, (layout, uid,
                                                               path)


def test_example_sp_gvr_two_ranks_exact(capsys, one_thread):
    res = sp_gvr_500k.main(["--device", "cpu", "--shards", "2",
                            "--n", "16384"])
    assert res["exact"] and res["secant_iters"] >= 1
    assert res["bill"]["secant"]["calls"] >= 1
    assert "SP-GVR exact over 2 sequence shards" in capsys.readouterr().out


def test_example_train_dsa_three_steps(one_thread):
    assert train_dsa.main(["--device", "cpu", "--steps", "3"]) == 0
