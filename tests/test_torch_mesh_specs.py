"""The port's sharding rules and specs against the JAX package's.

For all ten configs at their published widths, on the abstract meshes
(2, 2), (2, 8), (16, 16) and (2, 16, 16): `param_specs` (default rules and
each shape kind's `overrides_for`), `state_specs` (sequence-sharded and
not, at the decode cells' batch and length) and `overrides_for` itself
equal the reference's entry by entry; `input_specs` and
`decode_state_specs` equal the shapes and dtypes of JAX's
`ShapeDtypeStruct`s and `eval_shape`. Plus the reference's divisibility
cases (`tests/test_substrate.py`), the production meshes, and
`bridge.shard_tree` / `unshard_tree` against the blocks the specs give.
All in one process: the specs need axis sizes only, no devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget_config
from repro.models import api as japi
from repro.parallel import sharding as jsharding

from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.launch import make_production_mesh
from repro_torch.models import api
from repro_torch.parallel import sharding

MESHES = [((2, 2), ("data", "model")), ((2, 8), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = ["2x2", "2x8", "16x16", "2x16x16"]


def _flat(tree, prefix=""):
    """{path: spec as a tuple} of a nested dict of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree)}


def _rules(shape, axes, overrides=None):
    return (jsharding.make_rules(jsharding.abstract_mesh(shape, axes), overrides),
            sharding.make_rules(sharding.AbstractMesh(shape, axes), overrides))


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm, tm = japi.build_model(jcfg), api.build_model(cfg, device="cpu")
    for kind in ("train", "prefill", "decode"):
        assert sharding.overrides_for(cfg, kind) == jsharding.overrides_for(jcfg, kind)
        jr, tr = _rules(*mesh, jsharding.overrides_for(jcfg, kind))
        assert _flat(tm.param_specs(tr)) == _flat(jm.param_specs(jr)), kind
    jr, tr = _rules(*mesh)
    for shape in japi.supported_shapes(jcfg):
        cell = japi.SHAPES[shape]
        if cell["kind"] != "decode":
            continue
        for seq in (False, True):
            kw = dict(batch=cell["global_batch"], max_len=cell["seq_len"],
                      seq_sharded=seq)
            assert (_flat(tm.state_specs(tr, **kw))
                    == _flat(jm.state_specs(jr, **kw))), (shape, seq)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_cells_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm, tm = japi.build_model(jcfg), api.build_model(cfg, device="cpu")
    assert api.SHAPES == japi.SHAPES
    assert api.supported_shapes(cfg) == japi.supported_shapes(jcfg)

    def same(port, ref):
        assert sorted(port) == sorted(ref)
        for k in ref:
            assert port[k].shape == tuple(ref[k].shape), k
            assert str(port[k].dtype).split(".")[-1] == np.dtype(ref[k].dtype).name, k

    for shape in api.supported_shapes(cfg):
        same(tm.input_specs(shape), jm.input_specs(shape))
        if api.SHAPES[shape]["kind"] == "decode":
            same(tm.decode_state_specs(shape), jm.decode_state_specs(shape))
        else:
            with pytest.raises(ValueError, match="not a decode"):
                tm.decode_state_specs(shape)


def test_divisibility_fallback_as_the_reference():
    """`tests/test_substrate.py`'s cases, and the cases around them."""
    mesh = sharding.AbstractMesh((2, 8), ("data", "model"))
    rules = sharding.make_rules(mesh)
    jrules = jsharding.make_rules(jsharding.abstract_mesh((2, 8), ("data", "model")))
    assert rules.spec("d_model", "heads", sizes=(64, 28)) == sharding.P(None, None)
    assert rules.spec("d_model", "heads", sizes=(64, 32)) == sharding.P(None, "model")
    for logical, sizes in ((("batch", "vocab"), (4, 51865)),
                           (("batch", "vocab"), (3, 512)),
                           (("batch", "seq_shard", "kv_heads"), (2, 64, 8)),
                           (("heads", None), (16, 3)),
                           (("state", "d_ff", "indexer"), (5, 16, 7))):
        assert rules.spec(*logical, sizes=sizes) == tuple(jrules.spec(*logical, sizes=sizes))
        assert rules.spec(*logical) == tuple(jrules.spec(*logical))
    multi = sharding.make_rules(sharding.AbstractMesh((2, 2, 4), ("pod", "data", "model")))
    assert multi.spec("batch", sizes=(8,)) == (("pod", "data"),)
    assert multi.spec("batch", sizes=(6,)) == (None,)
    assert repr(sharding.P(None, "model")) == "P(None, 'model')"


def test_production_meshes_and_constrain():
    """The reference's production meshes need 256 and 512 devices; the
    port's are abstract, with the reference's axes and sizes."""
    for multi in (False, True):
        port = make_production_mesh(multi_pod=multi)
        want = ({"pod": 2, "data": 16, "model": 16} if multi
                else {"data": 16, "model": 16})
        assert port.shape == want and port.size == (512 if multi else 256)
        assert port.axis_names == tuple(want)
    rules = sharding.make_rules(make_production_mesh())
    x = torch.zeros(8, 128)
    assert sharding.constrain(x, None, "batch", "vocab") is x
    assert sharding.constrain(x, rules, "batch", "vocab", sizes=(128, 2048)) is x
    with pytest.raises(ValueError, match="block"):
        sharding.constrain(x, rules, "batch", "vocab", sizes=(128, 4096))
    with pytest.raises(ValueError, match="logical axes"):
        sharding.constrain(x, rules, "batch")


def test_shard_tree_gives_the_specs_blocks():
    """Every rank's block of llama's smoke parameters and a decode state on
    (2, 2) is the slice its spec names; the blocks rebuild the tree; an
    axis on two dimensions is refused, as JAX's NamedSharding refuses it."""
    cfg = get_config("llama3.2-1b", smoke=True)
    model = api.build_model(cfg, device="cpu")
    params = model.init_params(seed=0)
    mesh = sharding.AbstractMesh((2, 2), ("data", "model"))
    rules = sharding.make_rules(mesh)
    specs = model.param_specs(rules)
    blocks = [bridge.shard_tree(params, specs, mesh,
                                coords={"data": r // 2, "model": r % 2})
              for r in range(4)]
    wq = params["layers"]["wq"]
    half = wq.shape[2] // 2
    assert torch.equal(blocks[3]["layers"]["wq"], wq[:, :, half:])
    assert torch.equal(blocks[2]["layers"]["wq"], wq[:, :, :half])
    assert torch.equal(blocks[1]["embed"], params["embed"][cfg.vocab // 2:])
    assert torch.equal(blocks[1]["layers"]["indexer"]["wq"],
                       params["layers"]["indexer"]["wq"])
    back = bridge.unshard_tree(blocks, specs, mesh)
    for k, v in _flat_tensors(params).items():
        assert torch.equal(_flat_tensors(back)[k], v), k
    state = model.init_decode_state(4, 32)
    state["k"].normal_()
    sspecs = model.state_specs(rules, batch=4, max_len=32, seq_sharded=True)
    with pytest.raises(ValueError, match="two dimensions"):
        bridge.shard_tree(state, sspecs, mesh, coords={"data": 0, "model": 0})
    sspecs = model.state_specs(rules, batch=1, max_len=32, seq_sharded=True)
    one = model.init_decode_state(1, 32)
    one["k"].normal_()
    blk = bridge.shard_tree(one, sspecs, mesh, coords={"data": 1, "model": 0})
    assert torch.equal(blk["k"], one["k"][:, :, 16:, :1])
    assert torch.equal(blk["length"], one["length"])


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_decode_state_specs_allocate_nothing():
    """jamba's long_500k cache would be 9 x 524288 rows of every kind: the
    meta device gives its shapes without the memory."""
    model = api.build_model(get_config("jamba-1.5-large-398b"), device="cpu")
    specs = model.decode_state_specs("long_500k")
    ref = jax.eval_shape(lambda: japi.build_model(
        jget_config("jamba-1.5-large-398b")).init_decode_state(1, 524288))
    assert specs["k"] == api.ShapeDtype(tuple(ref["k"].shape), torch.bfloat16)
    assert ref["k"].dtype == jnp.bfloat16


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "llama3.2-1b",
                                  "moonshot-v1-16b-a3b", "whisper-medium",
                                  "rwkv6-3b"])
def test_sharded_init_gives_the_blocks_of_the_init(arch):
    """`init_params(mesh=, rules=)` is each rank's `shard_tree` of the
    unsharded init, bit for bit: every family cuts each layer as it is
    drawn."""
    model = api.build_model(get_config(arch, smoke=True), device="cpu")
    full = model.init_params(seed=3)
    mesh = sharding.AbstractMesh((2, 2), ("data", "model"))
    rules = sharding.make_rules(mesh)
    specs = model.param_specs(rules)
    for r in range(4):
        mesh.coords = {"data": r // 2, "model": r % 2}
        got = _flat_tensors(model.init_params(seed=3, mesh=mesh, rules=rules))
        want = _flat_tensors(bridge.shard_tree(full, specs, mesh))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (r, k)


@pytest.mark.parametrize("arch", ["whisper-medium", "rwkv6-3b"])
def test_enc_dec_and_ssm_steps_under_a_mesh_are_refused(arch):
    """Their steps run on a rank of a live mesh
    (`tests/test_torch_mesh_family_step.py`); under an abstract mesh,
    which has axis sizes and no rank, the step is refused with the
    reason, rather than failing inside."""
    model = api.build_model(get_config(arch, smoke=True), device="cpu")
    mesh = sharding.AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="AbstractMesh"):
        model.serve_step({}, {}, torch.zeros(2, dtype=torch.int32), mesh=mesh,
                         rules=sharding.make_rules(mesh))
