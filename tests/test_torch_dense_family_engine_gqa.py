"""The dense and paged engines of chatglm3-6b (16 query heads a KV head)
and granite-34b (48, one KV head) against the JAX engines, and paged ==
dense (moved here from `test_torch_dense_family_engine.py`, which holds
the trace and the check, so that no test file runs past the tier-1
budget)."""

import pytest

from test_torch_dense_family_engine import engines_match_jax


@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-34b"])
def test_engines_match_jax_and_paged_equals_dense(arch):
    engines_match_jax(arch)
