"""The reference against the port on the CPU (plain kernel forms, the
smoke configurations): a restored session decoded through `DecodeEngine`,
`dsa_select_paged` on flat and heavy-tailed rows, and the float8 control,
which the comparison must tell from the program."""

import numpy as np
import pytest
import torch

import smoke
from gvr_bench.harness import spec
from gvr_bench.harness.context import Context, Record
from gvr_bench.harness.model import port_config
from gvr_bench.reference import compare, model as ref_model, select as ref_select

SERVED = ["chatglm3-6b.docs-128k"]
SELECT = ["chatglm3-6b.select-128k", "chatglm3-6b.select-128k-flat"]


def driver(cell, seed=20261019, **traffic):
    p = smoke.parts(cell)
    p["traffic"].update(traffic)
    ctx = Context(cell=cell, seed=seed, trace=False, device=torch.device("cpu"),
                  cfg=port_config(p["config"]), conf=p["config"],
                  traffic=p["traffic"], workload=p["workload"])
    ctx.record = Record(cell=cell, model=p["config"]["model"])
    drv = spec.driver(p["traffic"]["driver"]).Driver(ctx)
    drv.setup()
    return drv


@pytest.mark.parametrize("cell", SERVED)
def test_restored_session_logits_agree_with_reference(cell):
    drv = driver(cell)
    drv.eng.record_logits = True
    first = drv.uid                      # requests submitted from here on
    for _ in range(300):                 # ticks until two of them are done
        drv._tick()
        done = [r for r in drv.done if r.uid >= first]
        if len(done) >= 2:
            break
    assert len(done) >= 2 and all(len(r.logits_log) == len(r.generated)
                                  for r in done)
    for req in done[:2]:
        fed = torch.as_tensor(np.append(req.prompt[-1:], req.generated[:-1]))
        ref = ref_model.logits(drv.weights, drv.m, fed, len(req.prompt) - 1,
                               lambda layer: drv._rows(drv.meta[req.uid]["doc"], layer),
                               dsa_on=True, eps=drv.m["norm_eps"])
        got = torch.as_tensor(np.stack(req.logits_log))
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-4 * scale
        assert torch.equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("cell", SELECT)
def test_dsa_select_paged_is_the_exact_topk(cell):
    drv = driver(cell)
    drv.window(0.3)
    assert drv.samples
    for smp in drv.samples:
        layer = smp["layer"]
        pool = drv.pools[layer]

        def keys(r, n):
            npg = -(-n // drv.ps)
            return pool[drv.table[r, :npg].long()].reshape(-1, drv.dim)[:n]

        ip = {k: v[layer] for k, v in drv.indexer.items()}
        scores = ref_select.scores(smp["x"], ip, smp["len_host"], keys,
                                   heads=drv.heads, dim=drv.dim,
                                   rope_base=drv.ctx.conf["model"]["rope_base"])
        for r, sc in enumerate(scores):
            want = set(ref_select.topk(sc, drv.k).tolist())
            assert set(smp["idx"][r].tolist()) == want
            assert torch.allclose(smp["vals"][r], sc[smp["idx"][r].long()],
                                  rtol=1e-5, atol=1e-6)
    checks = drv.check()
    assert checks == {"bad_entries": 0.0, "shortfall": 0.0,
                      "value_err": pytest.approx(0.0, abs=1e-5)}


def test_heavy_tailed_rows_keep_their_topk_across_steps():
    """sigma = 1 makes consecutive steps' Top-K overlap; sigma = 0 not."""
    shares = {}
    for cell in SELECT:
        drv = driver(cell, rows=4, capacity=2048, page_size=16,
                     start_low=1500, start_high=1900)
        drv.window(0.2)
        drv.traced()
        shares[cell] = drv.ctx.record.counters["prior_hit_share"]
    assert shares[SELECT[0]] > shares[SELECT[1]] + 0.2


@pytest.mark.parametrize("cell", SERVED)
def test_the_float8_control_is_told_apart(cell):
    drv = driver(cell)
    drv.window(1.5)
    drv.release()
    program = drv.check()["logit_gap"]
    control = drv.check(low="fp8")["logit_gap"]
    assert program < 1e-4 < control


@pytest.mark.parametrize("cell", SELECT)
def test_the_float8_control_of_selection_is_told_apart(cell):
    drv = driver(cell)
    drv.window(0.3)
    program = drv.check()
    control = drv.check(low="fp8")
    assert program["shortfall"] == 0.0
    assert control["shortfall"] > 1e-3 or control["value_err"] > 1e-3


def test_token_gaps_and_selection_numbers():
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.5, 0.1, 0.2]])
    assert compare.token_gaps(ref, torch.tensor([1, 2])).tolist() == \
        pytest.approx([0.0, 0.3])
    score = torch.tensor([5.0, 1.0, 4.0, 3.0, 2.0])
    got = compare.selection(torch.tensor([0, 2, 3]), torch.tensor([5.0, 4.0, 3.0]),
                            score, 3)
    assert got == {"bad_entries": 0.0, "shortfall": 0.0, "value_err": 0.0}
    got = compare.selection(torch.tensor([0, 2, 4]), torch.tensor([5.0, 4.0, 2.5]),
                            score, 3)
    assert got["shortfall"] == pytest.approx(1 / 3)
    assert got["value_err"] == pytest.approx(0.5 / 3)
    got = compare.selection(torch.tensor([0, 0, 9]), torch.tensor([5.0, 5.0, 0.0]),
                            score, 3)
    assert got["bad_entries"] == 2.0
