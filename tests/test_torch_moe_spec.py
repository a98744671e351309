"""The MoE family's speculative engine emits the non-speculative engine's
tokens, on both MoE smoke configs (moved here from `test_torch_moe.py`,
which keeps the fixtures and helpers, so that no test file runs past the
tier-1 budget)."""

from repro_torch.serve import DecodeEngine, Request

from test_torch_moe import _engine_run, moe


def test_spec_engine_emits_the_nonspec_tokens(moe):
    """The speculative engine (mq verify, the default n-gram drafter) on
    the staggered trace emits the tokens of the non-speculative engine."""
    _, _, tm, tparams = moe
    base = _engine_run(DecodeEngine, Request, tm, tparams, kv_layout="paged",
                       page_size=8)[1]
    spec = _engine_run(DecodeEngine, Request, tm, tparams, kv_layout="paged",
                       page_size=8, spec_depth=2, verify_kernel="mq")[1]
    assert [r.generated for r in spec] == [r.generated for r in base]
