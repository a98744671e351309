"""A whole run of each cell on the CPU at smoke size (the look for a card
skipped), with the timed path broken underneath: `correct` must come out
false for each fault the cell can have, and true with none."""

import pytest

import smoke
from gvr_bench.harness import runner

SEED = 3_000_000_019


def run(cell):
    return runner.run(cell, SEED, 1.5, False, device="cpu",
                      parts=smoke.parts(cell))


# ---- served cells: faults in the model step -----------------------------

def _unchanged_state(real):
    def step(params, state, tokens, cfg, **kw):
        logits, _ = real(params, state, tokens, cfg, **kw)
        return logits, state
    return step


def _half_batch(real):
    """The second half of the rows left out: their logits never computed
    (zeros)."""
    def step(params, state, tokens, cfg, **kw):
        logits, new = real(params, state, tokens, cfg, **kw)
        b = logits.shape[0]
        if b > 1:
            logits = logits.clone()
            logits[b // 2:] = 0.0
        return logits, new
    return step


def _altered_token(real):
    def step(params, state, tokens, cfg, **kw):
        logits, new = real(params, state, tokens, cfg, **kw)
        logits = logits.clone()
        logits[:, 7] += 100.0
        return logits, new
    return step


@pytest.mark.parametrize("cell", ["chatglm3-6b.docs-128k"])
@pytest.mark.parametrize("fault", [None, _unchanged_state, _half_batch,
                                   _altered_token])
def test_served_cell_fails_under_each_fault(cell, fault, monkeypatch):
    from repro_torch.models import transformer
    if fault is not None:
        monkeypatch.setattr(transformer, "serve_step_paged",
                            fault(transformer.serve_step_paged))
    out = run(cell)
    assert out["correct"] is (fault is None), out["checks"]


# ---- select cells: faults in the selection ------------------------------

def _returns_prev(real):
    def sel(params, x, pages, table, prev, lengths, **kw):
        out = real(params, x, pages, table, prev, lengths, **kw)
        return out._replace(indices=prev.clone())
    return sel


def _half_rows(real):
    def sel(params, x, pages, table, prev, lengths, **kw):
        out = real(params, x, pages, table, prev, lengths, **kw)
        idx, vals = out.indices.clone(), out.values.clone()
        b = idx.shape[0]
        idx[b // 2:], vals[b // 2:] = idx[:1], vals[:1]
        return out._replace(indices=idx, values=vals)
    return sel


def _altered_answer(real):
    def sel(params, x, pages, table, prev, lengths, **kw):
        out = real(params, x, pages, table, prev, lengths, **kw)
        idx = out.indices.clone()
        idx[0, 0] = (idx[0, 0] + 1) % int(lengths[0])
        return out._replace(indices=idx)
    return sel


@pytest.mark.parametrize("cell", ["chatglm3-6b.select-128k",
                                  "chatglm3-6b.select-128k-flat"])
@pytest.mark.parametrize("fault", [None, _returns_prev, _half_rows,
                                   _altered_answer])
def test_select_cell_fails_under_each_fault(cell, fault, monkeypatch):
    from repro_torch.sparse import dsa
    if fault is not None:
        monkeypatch.setattr(dsa, "dsa_select_paged",
                            fault(dsa.dsa_select_paged))
    out = run(cell)
    assert out["correct"] is (fault is None), out["checks"]


# ---- the float8 control in the program's place ----------------------------

@pytest.mark.parametrize("cell", ["chatglm3-6b.docs-128k",
                                  "chatglm3-6b.select-128k",
                                  "chatglm3-6b.select-128k-flat"])
def test_the_float8_control_is_not_correct_under_the_runs_limits(cell):
    """The control goes through the run's own comparison with the cell's
    limits, as the readings on the card route it: correct comes out false
    for it and true for the program. The run is made the same on every
    machine: a window of one tick or step, after a set-up whose warm-up
    ticks finish the requests checked. The served smoke model holds
    `logit_gap` to a limit of its size's own: over five seeds the program
    read 0.0 and the control 0.1885-0.6071."""
    parts = smoke.parts(cell)
    if parts["traffic"]["driver"] == "engine":
        parts["traffic"].update(out_low=8, out_high=24, check_requests=4,
                                warmup_ticks=60)
        parts["workload"]["limits"]["logit_gap"] = 0.05
    out = runner.run(cell, SEED, 0.0, False, device="cpu", parts=parts,
                     controls=("fp8",))
    assert out["correct"] is True, out["checks"]
    assert out["controls"]["fp8"]["correct"] is False, out["controls"]
