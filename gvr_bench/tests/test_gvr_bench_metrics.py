"""Every metric reader of gvr_bench/metrics on a hand-made record and
trace, against values worked out by hand."""

import pytest

from gvr_bench.counts import h100, kernels, step
from gvr_bench.harness import spec
from gvr_bench.harness import trace as tr
from gvr_bench.harness.context import Record

MS = 1_000_000  # ns


def _trace():
    # window [0, 10 ms]; device: scoring 1-3 ms and 2-4 ms (overlapping),
    # B1 5-6 ms, a copy 8-8.5 ms; host: a harness span over 0-10 ms and
    # an op over 6-8 ms
    dev = [("indexer_scores_mma_kernel<64>", 1 * MS, 3 * MS),
           ("indexer_scores_mma_kernel<64>", 2 * MS, 4 * MS),
           ("gvr_topk_kernel", 5 * MS, 6 * MS),
           ("Memcpy DtoH", 8 * MS, 8 * MS + MS // 2)]
    host = [(tr.WINDOW, 0, 10 * MS, True),
            ("harness.tick", 0, 10 * MS, True),
            ("aten::argmax", 6 * MS, 8 * MS, False)]
    return tr.TraceData(device=dev, host=host, window=(0, 10 * MS))


def _launches():
    sc = {"kind": "b2_scoring", "lengths": [8192, 5000], "heads": 64,
          "dim": 128, "page_size": 64}
    return [sc, dict(sc), {"kind": "b1", "lengths": [8192, 5000], "m": 2048,
                           "k": 2048}]


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_idle_share():
    rec = Record(cell="c", model={}, trace=_trace())
    # busy: 1-4, 5-6, 8-8.5 = 4.5 ms of 10
    for cell in ("serve", "select"):
        assert read(f"device_idle_pct.{cell}", rec) == pytest.approx(55.0)
    assert tr.busy_s(rec.trace) == pytest.approx(4.5e-3)


def test_rooflines():
    rec = Record(cell="c", model={}, trace=_trace(), launches=_launches())
    nb, fl = kernels.b2_scoring([8192, 5000], heads=64, dim=128,
                                page_size=64)
    want = 100 * h100.bound_s(nb, fl) / 2e-3       # 2 launches of 2 ms
    for cell in ("serve", "select"):
        assert read(f"score_roofline_pct.{cell}", rec) == pytest.approx(want)
    nb, fl = kernels.b1([8192, 5000], m=2048, k=2048)
    assert read("topk_roofline_pct.serve", rec) == pytest.approx(
        100 * h100.bound_s(nb, fl) / 1e-3)


def test_readers_find_nothing_without_a_trace():
    rec = Record(cell="c", model={})
    for name in ("device_idle_pct.serve", "score_roofline_pct.select",
                 "topk_roofline_pct.serve", "tpot_p95_ms.serve",
                 "step_mfu_pct.serve", "gvr_passes.select",
                 "prior_hit_pct.select", "decode_tok_s", "select_us"):
        assert read(name, rec) is None, name


def test_breakdown_names_ops_and_idle_by_host_activity():
    b = tr.breakdown(_trace())
    assert b["device_ops"][0] == ["indexer_scores_mma_kernel<64>", 4e-3]
    idle = dict((n, s) for n, s in b["idle_gaps"])
    # gaps 0-1, 4-5, 6-8 (argmax on the host), 8.5-10
    assert idle["harness.tick/aten::argmax"] == pytest.approx(2e-3)
    assert idle["harness.tick/python"] == pytest.approx(3.5e-3)


def test_end_to_end_readers():
    rec = Record(cell="c", model={}, window_s=2.0, setup_s=31.5)
    rec.counters.update(decoded_tokens=300, steps=50, layers=28)
    assert read("decode_tok_s", rec) == pytest.approx(150.0)
    assert read("select_us", rec) == pytest.approx(2.0 / 1400 * 1e6)
    assert read("setup_s", rec) == 31.5


def test_tpot_p95():
    rec = Record(cell="c", model={}, gaps_ms=[float(i) for i in range(1, 101)])
    assert read("tpot_p95_ms.serve", rec) == pytest.approx(95.05)


def test_step_mfu():
    m = spec.config("chatglm3-6b")["model"]
    ticks = [[70000] * 8, [70001] * 8 + [90000]]
    rec = Record(cell="c", model=m, window_s=0.2, ticks=ticks)
    least = sum(h100.bound_s(*step.tick(m, t, dsa_on=True)) for t in ticks)
    assert read("step_mfu_pct.serve", rec) == pytest.approx(100 * least / 0.2)
    # a tick's bytes: the weights but the embedding (13.86 GB) and, a row
    # and layer, 70000 indexer keys and 2048 K/V rows (22.1 MB)
    nb, _ = step.tick(m, ticks[0], dsa_on=True)
    want = 13.863e9 + 8 * 28 * (70000 * 256 + 2048 * 2 * 128 * 4)
    assert nb == pytest.approx(want, rel=1e-3)


def test_selection_counters():
    rec = Record(cell="c", model={})
    rec.counters.update(gvr_passes_mean=2.5, prior_hit_share=0.8125)
    assert read("gvr_passes.select", rec) == 2.5
    assert read("prior_hit_pct.select", rec) == 81.25


def test_every_listed_metric_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
