"""The JAX package's `test_arch_loss_decreases` on the hybrid smoke config
(jamba-1.5-large-398b) in the port (moved here from
`test_torch_train_families.py`, so that no test file runs past the
tier-1 budget): 8 training steps as
`_train_common.assert_train_steps_match_jax` states (the port's own run
within 1e-4 of JAX's losses, falling; each step from JAX's state within
1e-5 in the loss, 1e-4 in the state)."""

import pytest

from _train_common import (assert_train_steps_match_jax,
                           one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b"])
def test_train_loss_decreases_as_jax(arch):
    """The JAX package's `test_arch_loss_decreases` on the ssm and hybrid
    smoke configs, in both packages, step by step."""
    assert_train_steps_match_jax(arch)
