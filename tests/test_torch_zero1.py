"""ZeRO-1 moments, `shardings_for` and the mesh checkpoint against the JAX
package.

* `adamw.zero1_specs` and `launch.train.shardings_for` equal the
  reference's entry by entry for all ten configs at their published
  widths on the abstract meshes (2, 2), (2, 8), (16, 16) and (2, 16, 16)
  (no ranks: the specs need axis sizes only), and the reference's own
  case (`tests/test_substrate.py::test_zero1_specs_shard_moments`).
* On 4 gloo ranks (`_sp_rank.py ckpt`): llama's smoke config takes a
  ZeRO-1 step on (2, 2) and saves (params, opt_state) from the mesh;
  restored on (2, 2) it gives back the saved blocks, and the next step
  from it equals the uninterrupted run's bit for bit; restored on (4, 1)
  and on one device it gives the same logical bits; and the files equal
  a one-device save of those values.
"""

from __future__ import annotations

import json
import types

import jax
import numpy as np
import pytest
import torch

from _sp_common import run_ranks
from test_torch_mesh_step import _jax_model
from test_torch_mesh_train import train_inputs

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget_config
from repro.launch.train import shardings_for as jshardings_for
from repro.models.api import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import shardings_for
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import AbstractMesh, P, make_rules
from repro_torch.tree import flatten_with_paths, spec_leaves

MESHES = [((2, 2), ("data", "model")), ((2, 8), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["2x2", "2x8", "16x16", "2x16x16"]


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_and_shardings_for_equal_the_reference(arch, mesh):
    shape, axes = mesh
    jm = jbuild(jget_config(arch))
    jmesh = jsharding.abstract_mesh(shape, axes)
    tm = build_model(get_config(arch), device="cpu")
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    sizes = jax.tree.map(lambda s: types.SimpleNamespace(shape=tuple(s.shape)),
                         shapes)
    for kind in ("train", "decode"):
        over = jsharding.overrides_for(jm.cfg, kind)
        jrules = jsharding.make_rules(jmesh, over)
        trules = make_rules(AbstractMesh(shape, axes), over)
        jp, jo = jshardings_for(jm, jmesh, jrules, shapes, None)
        tp, to = shardings_for(tm, AbstractMesh(shape, axes), trules, sizes)
        want = [tuple(s.spec) for s in jax.tree.leaves((jp, jo))]
        got = [tuple(s) for s in spec_leaves((tp, to))]
        assert got == want, (kind, [(g, w) for g, w in zip(got, want) if g != w][:4])
        jz = jadamw.zero1_specs(jm.param_specs(jrules), jrules, sizes_tree=shapes)
        tz = adamw.zero1_specs(tm.param_specs(trules), trules, sizes_tree=sizes)
        assert [tuple(s) for s in spec_leaves(tz)] == [
            tuple(s) for s in jax.tree.leaves(
                jz, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def test_zero1_specs_shard_moments():
    """The reference's case, restated: a free dimension that divides
    picks up the "data" shard, one that does not stays replicated."""
    rules = make_rules(AbstractMesh((2, 2), ("data", "model")))
    out = adamw.zero1_specs({"w": P(None, "model"), "tiny": P(None)}, rules,
                            sizes_tree={"w": (8, 4), "tiny": (3,)})
    assert out["w"] == P("data", "model")
    assert out["tiny"] == P(None)
    with pytest.raises(ValueError):
        adamw.zero1_specs({"w": P(None)}, rules)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    inp = train_inputs("ckpt", "llama3.2-1b", 1)
    inp["ckpt_dir"] = np.asarray(str(tmp / "ckpt"))
    np.savez(tmp / "inputs.npz", **inp)
    return tmp, run_ranks("ckpt", 4, tmp)


def _specs(mesh_shape):
    model = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    mesh = AbstractMesh(mesh_shape, ("data", "model"))
    full = bridge.params_from_numpy(_jax_model("llama3.2-1b", None)[1])
    return mesh, shardings_for(model, mesh, make_rules(mesh), full), full


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_mesh_restart_on_the_same_mesh_is_bit_exact(ckpt):
    _, ranks = ckpt
    for res in ranks:
        assert res["restored_step"] == 1 and res["restored_equal"]
        _assert_trees_equal(res["resumed"], res["uninterrupted"])


def test_mesh_checkpoint_restores_on_another_mesh_and_one_device(ckpt):
    tmp, ranks = ckpt
    mesh22, specs22, full = _specs((2, 2))
    mesh41, specs41, _ = _specs((4, 1))
    saved = bridge.unshard_tree([r["saved"] for r in ranks], specs22, mesh22)
    on41 = bridge.unshard_tree([r["restored41"] for r in ranks], specs41, mesh41)
    like = (full, adamw.init(full))
    one, step = checkpoint.restore_latest(str(tmp / "ckpt"), like)
    assert step == 1
    _assert_trees_equal(on41, saved)
    _assert_trees_equal(one, saved)
    # (4, 1): each rank a quarter of the moments over "data"
    assert ranks[1]["coords41"] == {"data": 1, "model": 0}
    assert ranks[1]["restored41"][1].m["embed"].shape == (512, 128 // 4)


def test_mesh_checkpoint_files_equal_a_one_device_save(ckpt):
    tmp, _ = ckpt
    full = bridge.params_from_numpy(_jax_model("llama3.2-1b", None)[1])
    like = (full, adamw.init(full))
    one, _ = checkpoint.restore_latest(str(tmp / "ckpt"), like)
    checkpoint.save(str(tmp / "one"), one, 1)
    a, b = tmp / "ckpt" / "step_1", tmp / "one" / "step_1"
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    with np.load(a / "arrays.npz") as x, np.load(b / "arrays.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), k
