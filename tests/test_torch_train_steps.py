"""The JAX package's `test_arch_loss_decreases` in the port, on the dense
and MoE smoke configs (moved here from `test_torch_train.py`, so that no
test file runs past the tier-1 budget): 8 training steps free-running
within 1e-4 of JAX's losses, and each step from JAX's state within 1e-5 of
its loss and 1e-4 of its next parameters and moments
(`_train_common.assert_train_steps_match_jax`)."""

import pytest

from _train_common import (assert_train_steps_match_jax,
                           one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_train_loss_decreases_as_jax(arch):
    assert_train_steps_match_jax(arch)
