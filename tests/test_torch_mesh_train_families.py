"""The loss and gradients of the enc-dec, ssm and hybrid families on a
("data", "model") mesh against the JAX package's mesh step.

whisper-medium's, rwkv6-3b's and jamba's smoke configs on a port (2, 2)
mesh of 4 gloo ranks (`_sp_rank.py train`, no optimizer step) against
`jax.value_and_grad` of the reference's `loss_fn(mesh=, rules=)`, jitted
and placed by its `shardings_for` on 4 forced host devices
(`_mesh_train_jax.py`), from `init_params(PRNGKey(0))` and the data
pipeline's batch (whisper's with frames): the loss within 1e-5 relative
and every gradient leaf (the ranks' blocks joined by `unshard_tree`)
within 1e-4 relative L2, as `test_torch_mesh_train.py` holds llama and
moonshot. whisper's encoder and decoder on the rank's heads and `d_ff`
(the biases cut to its columns); rwkv6's time-mix projections gathered
and the recurrence on every head; jamba's Mamba on the rank's channels
and its MoE through the capacity dispatch.
"""

from __future__ import annotations

import numpy as np
import pytest

from _sp_common import run_jax_and_ranks
from test_torch_mesh_train import assert_grads_match, train_inputs

CASES = {"whisper": "whisper-medium", "rwkv6": "rwkv6-3b",
         "jamba": "jamba-1.5-large-398b"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train_families")
    inp = {"train_cases": np.asarray(list(CASES))}
    for c, arch in CASES.items():
        inp.update(train_inputs(c, arch, 0))
    np.savez(tmp / "inputs.npz", **inp)
    return run_jax_and_ranks(open("tests/_mesh_train_jax.py").read(),
                             "train", 4, tmp)


@pytest.mark.parametrize("c", list(CASES))
def test_family_mesh_loss_and_grads_match_jax_mesh_step(runs, c):
    jax_out, ranks = runs
    assert_grads_match(jax_out, ranks, c, CASES[c], 0)


def test_family_mesh_bills(runs):
    """Each family's collectives on "model": whisper's GELU bias cut
    (its gradient summed), rwkv6's gathered projections, jamba's Mamba
    and expert exchanges."""
    _, ranks = runs
    model = {c: set(ranks[0][c]["bill"]["model"]) for c in CASES}
    assert {"ffn", "cols_of_grad", "wo", "wq_grad"} <= model["whisper"], model
    assert {"wr", "wk", "wv", "wg", "wo", "cv", "ck_grad"} <= model["rwkv6"], model
    assert {"in_proj", "x_proj", "out_proj", "conv_w_grad", "ep_dispatch",
            "ep_return_grad"} <= model["jamba"], model
