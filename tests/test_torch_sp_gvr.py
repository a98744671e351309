"""SP-GVR of the port against the JAX package.

The port runs on 2 and 4 gloo ranks on the CPU (one process each, spawned
here); the JAX side runs once, in a subprocess with a forced 4-device host
mesh. Held: `sp_gvr_topk` on the JAX package's own cases (normal, ties,
lognormal, K = 1) at S = 2 and 4 — indices, threshold and secant
iterations equal, the exact Top-K; the one-rank case against
single-device GVR; and the mesh's refusals.
"""

import numpy as np
import pytest
import torch

from _sp_common import run_jax, run_ranks
from repro_torch.launch import make_seq_mesh

pytestmark = pytest.mark.mesh

CASES = ("normal", "ties", "lognormal", "k1")


def _inputs(rng):
    out = {}
    for name, gen, k in (
            ("normal", lambda: rng.normal(size=(2, 8192)), 256),
            ("ties", lambda: rng.integers(0, 4, size=(2, 8192)).astype(float), 256),
            ("lognormal", lambda: rng.lognormal(0, 2, size=(2, 8192)), 128),
            ("k1", lambda: rng.normal(size=(1, 4096)), 1)):
        x = gen().astype(np.float32)
        xp = x + 0.05 * rng.normal(size=x.shape)
        out[f"gvr_x_{name}"] = x
        out[f"gvr_prev_{name}"] = np.argsort(-xp, -1)[:, :max(k, 8)].astype(np.int32)
        out[f"gvr_k_{name}"] = np.int32(k)
    return out


_JAX = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import sp_gvr_topk
from repro.launch.mesh import make_mesh

tmp = sys.argv[1]
inp = dict(np.load(tmp + "/inputs.npz"))
out = {}
for s in (2, 4):
    mesh = make_mesh((s,), ("data",))
    # one compile for the cases of one shape and K (normal, ties)
    topk = jax.jit(sp_gvr_topk, static_argnums=(2, 3))
    for name in ("normal", "ties", "lognormal", "k1"):
        idx, thr, it = topk(jnp.asarray(inp["gvr_x_" + name]),
                            jnp.asarray(inp["gvr_prev_" + name]),
                            int(inp["gvr_k_" + name]), mesh)
        out[f"gvr{s}_{name}_idx"] = np.asarray(idx)
        out[f"gvr{s}_{name}_thr"] = np.asarray(thr)
        out[f"gvr{s}_{name}_iters"] = np.asarray(it)

np.savez(tmp + "/jax.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_gvr")
    inputs = _inputs(np.random.default_rng(11))
    np.savez(tmp / "inputs.npz", **inputs)
    jax_out = run_jax(_JAX, tmp)
    port = {s: run_ranks("gvr", s, tmp) for s in (2, 4)}
    return inputs, jax_out, port


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_sp_gvr_topk_equals_jax(runs, shards, case):
    """Indices (in the wrapper's compacted order), threshold and secant
    iterations equal JAX's on every rank; the set is the exact Top-K."""
    inputs, jax_out, port = runs
    x, k = inputs[f"gvr_x_{case}"], int(inputs[f"gvr_k_{case}"])
    for rank_out in port[shards]:
        idx, thr, iters = (t.numpy() for t in rank_out[case])
        np.testing.assert_array_equal(idx, jax_out[f"gvr{shards}_{case}_idx"])
        np.testing.assert_array_equal(thr, jax_out[f"gvr{shards}_{case}_thr"])
        np.testing.assert_array_equal(iters, jax_out[f"gvr{shards}_{case}_iters"])
        got = np.sort(np.take_along_axis(x, idx.astype(np.int64), -1), -1)
        np.testing.assert_array_equal(got, np.sort(-np.sort(-x, -1)[:, :k], -1))
        assert all(len(set(r.tolist())) == k for r in idx)


def test_one_rank_degenerates_to_single_device_gvr():
    """With one rank (no process group) SP-GVR is GVR: the same Top-K set
    and threshold as the port's `gvr_topk` and as the JAX package's
    `sp_gvr_topk` on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from repro.core import sp_gvr_topk as jax_sp_gvr
    from repro.launch.mesh import make_mesh
    from repro_torch.core import gvr_topk, sp_gvr_topk
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 2048)).astype(np.float32)
    prev = np.stack([rng.choice(2048, 128, replace=False)
                     for _ in range(2)]).astype(np.int32)
    mesh = make_seq_mesh(1, device="cpu")
    assert mesh.size == 1 and mesh.rank == 0
    idx, thr, iters = sp_gvr_topk(torch.from_numpy(x), torch.from_numpy(prev),
                                  128, mesh)
    single = gvr_topk(torch.from_numpy(x), torch.from_numpy(prev), 128)
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), single.indices.numpy())
    np.testing.assert_array_equal(thr.numpy(), single.stats.threshold.numpy())
    jidx, jthr, jiters = jax.jit(jax_sp_gvr, static_argnums=(2, 3))(
        jnp.asarray(x), jnp.asarray(prev), 128, make_mesh((1,), ("data",)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jiters))
    assert mesh.bill() == {}


def test_mesh_refusals_are_actionable(runs):
    """No group for S > 1, a group of the wrong size and a backend other
    than the group's raise ValueError naming how to launch S ranks; the
    default device needs CUDA (no silent CPU); S < 1 is refused."""
    _, _, port = runs
    errors = port[2][0]["errors"]
    assert "holds 2 rank(s)" in errors["size"] and "init_seq_group" in errors["size"]
    assert "'gloo', not the requested backend 'nccl'" in errors["backend"]
    with pytest.raises(ValueError, match="none is initialised.*one process per shard"):
        make_seq_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="seq_shards must be >= 1"):
        make_seq_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_seq_mesh(1)
    # the sharded run's collectives were counted, all O(1) in the row
    bill = port[4][0]["bill"]
    assert {"phase1", "secant", "hist", "snap", "extract", "wrapper"} <= set(bill)
