"""The enc-dec, ssm and hybrid families' training path in the port
against the JAX package: whisper-medium (with frames: the encoder, the
causal RoPE self-attention and cross-attention under autograd), rwkv6-3b
(the WKV6 recurrence over S) and jamba (a superblock of attention, 7
Mamba layers, MoE and dense feed-forwards), on their float32 smoke
configs with the JAX init's constant leaves perturbed (`_train_common`).

Tolerances (`_train_common`): loss within 1e-5 relative, each gradient
leaf within 1e-4 relative L2 of `jax.value_and_grad`, the indexer's
leaves exactly zero in both; one AdamW step from JAX's gradients gives
parameters within 1e-6 relative L2 of JAX's and moments within 2e-5
(they carry the clip scale, whose grad norm is summed in another
order). The 8-step runs of the ssm and hybrid configs are in
`test_torch_train_rwkv6.py` and `test_torch_train_jamba.py` (moved there
so that no test file runs past the tier-1 budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths

from _train_common import (assert_loss_grads_match, jax_loss_grads,
                           one_thread, setup)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FAMILY_ARCHS = ["whisper-medium", "rwkv6-3b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    """Loss and every gradient leaf, B = 2, S = 32 (whisper with its 64
    random frames, so the encoder's leaves get gradients)."""
    assert_loss_grads_match(arch, 2, 32, seed=6, remat=remat)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_adamw_step_matches_jax(arch):
    """One AdamW step of the family's tree from JAX's own gradients (of
    the loss test's batch) with the default AdamWConfig in both packages:
    lr within a float32 ulp; grad_norm within 1e-5 relative (each leaf's
    sum of squares is reduced in another order; jamba's lands 2e-6
    apart); the moments, which carry the clip scale 1 / grad_norm (v its
    square), within 2e-5 relative L2; the new parameters, where Adam's
    ratio m / sqrt(v) cancels the scale, within 1e-6; the indexer's
    zero-gradient leaves decayed alike."""
    jm, jparams, nparams, tm = setup(arch)
    _, jgrads = jax_loss_grads(arch, 2, 32, 6)
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jparams), [g for _, g in jgrads])
    jp, jo, jmet = jadamw.update(jax.tree.map(jnp.asarray, jtree),
                                 jadamw.init(jparams), jparams,
                                 jadamw.AdamWConfig())
    params = bridge.params_from_numpy(nparams)
    tp, to, tmet = adamw.update(bridge.params_from_numpy(jtree),
                                adamw.init(params), params,
                                adamw.AdamWConfig())
    want = np.float32(jmet["lr"])
    assert abs(np.float32(tmet["lr"]) - want) <= np.spacing(want)
    want = float(jmet["grad_norm"])
    assert abs(float(tmet["grad_norm"]) - want) <= 1e-5 * want
    for got_tree, want_tree, tol in ((tp, jp, 1e-6), (to.m, jo.m, 2e-5),
                                     (to.v, jo.v, 2e-5)):
        want = {jax.tree_util.keystr(k): np.asarray(a) for k, a in
                jax.tree_util.tree_flatten_with_path(want_tree)[0]}
        for path, got in flatten_with_paths(got_tree):
            w = want[path]
            rel = np.linalg.norm(got.numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= tol, (path, rel)


