"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX package.

  (a) On a (2, 4) ("data", "model") mesh of 8 forced host devices, XLA's
      `memory_analysis()` of the reference's compiled step (built with the
      JAX package's own spec trees, `keep_unused=True`; `_dryrun_jax.py`,
      one subprocess) equals the port's `cell_bytes` on the same smoke
      cells: argument, output and alias bytes, byte for byte.
  (b) Every production cell at 16 x 16 (2 x 16 x 16 in
      `test_torch_dryrun_pod2.py`): `run_cell`'s status is the reference's
      `supported_shapes` rule, and its per-rank bytes of each argument kind
      equal the sum of `NamedSharding(AbstractMesh, spec).shard_shape` x
      itemsize over the reference's spec trees and `eval_shape` leaves.
  (c) The JSON's fields and the CLI's exit codes.
  (d) `model_flops` against a hand count.
  (e) The kernel wrappers on meta inputs give the shapes and dtypes of
      their plain versions, launch nothing, and refuse mixed devices; the
      `ShadowMesh`'s collectives give the live shapes and bill as the live
      mesh bills.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from _dryrun_jax import shard_sums
from _mesh_compat import REPO_ROOT, forced_mesh_env

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget_config
from repro.models.api import supported_shapes as jsupported

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.models.api import SHAPES, build_model
from repro_torch.parallel.sharding import (AbstractMesh, ShadowMesh,
                                           make_rules, overrides_for)

XLA_CELLS = ["llama3.2-1b:train_4k", "llama3.2-1b:prefill_32k",
             "llama3.2-1b:decode_32k", "moonshot-v1-16b-a3b:train_4k",
             "whisper-medium:decode_32k", "jamba-1.5-large-398b:long_500k"]


@pytest.fixture(scope="module")
def xla_memory():
    """XLA's numbers, computed in a subprocess that starts with the module
    and runs beside its other tests."""
    proc = subprocess.Popen(
        [sys.executable, "tests/_dryrun_jax.py", "2", "4", *XLA_CELLS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=forced_mesh_env(8), cwd=REPO_ROOT)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def check_production_cells(arch, multi_pod):
    """(b) for one arch on one production mesh."""
    jcfg = jget_config(arch)
    for shape in SHAPES:
        res = dryrun.run_cell(arch, shape, multi_pod)
        want = "ok" if shape in jsupported(jcfg) else "skipped"
        assert res["status"] == want, (shape, res.get("error"))
        if want == "skipped":
            assert res["reason"] == dryrun.SKIP_REASON
            continue
        assert res["per_rank"] == shard_sums(arch, shape, multi_pod), shape
        assert (res["memory"]["argument_size_in_bytes"]
                == sum(res["per_rank"].values()))
        assert res["n_devices"] == (512 if multi_pod else 256)


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_pod1_match_shard_shapes(arch, xla_memory):
    check_production_cells(arch, False)


def test_dryrun_json_fields_and_cli(capsys):
    res = dryrun.run_cell("llama3.2-1b", "decode_32k", False)
    for key in ("arch", "shape", "multi_pod", "n_devices", "kind", "params",
                "active_params", "status", "lower_s", "memory", "per_rank",
                "bill", "collectives", "model_flops_per_device",
                "flops_source"):
        assert key in res, key
    assert set(res["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "alias_size_in_bytes"}
    assert set(res["per_rank"]) == {"params", "moments", "state", "inputs"}
    assert set(res["collectives"]) == set(dryrun.COLLECTIVES) | {
        "total_bytes", "total_count"}
    for name in ("reduce-scatter", "collective-permute"):
        assert res["collectives"][name] == {"count": 0, "bytes": 0}
    assert res["collectives"]["total_count"] == sum(
        t["calls"] for tags in res["bill"].values() for t in tags.values())
    assert res["bill"]["model"]["logits"]["calls"] == 1
    assert res["flops_source"] == "6N/2N model FLOPs, attention not counted"
    assert "flops_per_device" not in res and "temp_size_in_bytes" not in str(res)
    json.dumps(res)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out)["status"] == "ok"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k"])
    assert e.value.code == 0
    assert json.loads(capsys.readouterr().out)["status"] == "skipped"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k"])
    assert e.value.code == 1
    assert json.loads(capsys.readouterr().out)["status"] == "error"


def test_dryrun_model_flops_hand_count():
    cfg = get_config("llama3.2-1b", smoke=True)
    # d 128, f 256, V 512 tied, 2 layers, 4 heads of 32, 2 KV heads,
    # indexer 4 heads of 16
    emb = 512 * 128
    attn = 128 * 32 * (4 + 2 * 2) + 4 * 32 * 128
    ffn = 3 * 128 * 256
    indexer = 128 * 4 * 16 + 128 * 16
    n = emb + 2 * (attn + ffn + indexer)
    assert n == 380928 == cfg.active_param_count()
    assert dryrun.model_flops(cfg, "train_4k", 256) == 6 * n * 256 * 4096 / 256
    assert dryrun.model_flops(cfg, "prefill_32k", 512) == 2 * n * 32 * 32768 / 512
    assert dryrun.model_flops(cfg, "decode_32k", 256) == 2 * n * 128 / 256
    assert dryrun.model_flops(cfg, "long_500k") == 2 * n


def _meta(t):
    return t.to("meta")


def test_dryrun_kernel_wrappers_on_meta():
    g = torch.Generator().manual_seed(0)
    b, n, h, d, kvh, hd, k = 3, 96, 4, 16, 2, 32, 8
    q = torch.randn(b, h, d, generator=g)
    kc = torch.randn(b, n, d, generator=g)
    w = torch.rand(h, generator=g)
    lengths = torch.tensor([96, 50, 9], dtype=torch.int32)
    prev = torch.randint(0, 40, (b, k), generator=g, dtype=torch.int32)
    aq = torch.randn(b, 2 * kvh, hd, generator=g)
    cache = torch.randn(b, n, kvh, hd, generator=g)
    idx = torch.randint(-1, 40, (b, k), generator=g, dtype=torch.int32)
    calls = [
        (ops.indexer_scores, (q, kc, w, lengths), {}),
        (ops.gvr_topk, (ref.indexer_scores_ref(q, kc, w, lengths), prev, k),
         {}),
        (ops.indexer_topk, (q, kc, w, prev, k), {"lengths": lengths}),
        (ops.sparse_decode_attn, (aq, cache, cache, idx, lengths), {}),
    ]
    ops.reset_launch_counts()
    for fn, args, kw in calls:
        plain = fn(*args, **kw)
        meta = fn(*[_meta(a) if torch.is_tensor(a) else a for a in args],
                  **{key: _meta(v) for key, v in kw.items()})
        plain = plain if isinstance(plain, tuple) else (plain,)
        meta = meta if isinstance(meta, tuple) else (meta,)
        assert [(t.shape, t.dtype) for t in meta] == [
            (t.shape, t.dtype) for t in plain], fn.__name__
        assert all(t.is_meta for t in meta)
        with pytest.raises(ValueError):      # meta beside the CPU
            fn(*[_meta(a) if i == 0 else a for i, a in enumerate(args)], **kw)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError):          # a shape that does not fit
        ops.sparse_decode_attn(_meta(aq[:2]), _meta(cache), _meta(cache),
                               _meta(idx), _meta(lengths))


def test_dryrun_shadow_mesh_collectives():
    mesh = ShadowMesh((2, 4), ("data", "model"), coords={"model": 3})
    assert mesh.rank == 3 and mesh.coords == {"data": 0, "model": 3}
    ax = mesh.axis("model")
    assert (ax.size, ax.rank) == (4, 3)
    x = torch.empty(6, 8, device="meta")
    assert ax.psum(x, "a").shape == (6, 8)
    assert ax.psum(torch.empty(5, dtype=torch.bool, device="meta"),
                   "i").dtype == torch.int32
    assert ax.pmax(x, "b").shape == (6, 8)
    assert ax.all_gather(x, dim=1, tiled=True, tag="c").shape == (6, 32)
    assert ax.all_gather(x, dim=0, tag="d").shape == (4, 6, 8)
    assert ax.all_to_all(x, 1, 0, tag="e").shape == (24, 2)
    assert mesh.axis("pod").size == 1
    assert mesh.axis("pod").psum(x, "none") is x
    assert mesh.bill() == {"model": {
        "a": {"calls": 1, "bytes": 192}, "b": {"calls": 1, "bytes": 192},
        "c": {"calls": 1, "bytes": 192}, "d": {"calls": 1, "bytes": 192},
        "e": {"calls": 1, "bytes": 192}, "i": {"calls": 1, "bytes": 20}}}
    col = mesh.collectives()
    assert col["all-reduce"] == {"count": 3, "bytes": 192 * 2 + 20}
    assert col["all-gather"] == {"count": 2, "bytes": 2 * 4 * 192}
    assert col["all-to-all"] == {"count": 1, "bytes": 192}
    assert col["total_count"] == 6
    mesh.reset_bill()
    assert mesh.bill() == {} and mesh.collectives()["total_count"] == 0
    with pytest.raises(ValueError):
        ShadowMesh((2, 4), ("data", "model"), coords={"model": 4})


def test_dryrun_cell_bytes_equal_xla(xla_memory):
    mesh = AbstractMesh((2, 4), ("data", "model"))
    out, err = xla_memory.communicate(timeout=600)
    assert xla_memory.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    for cell in XLA_CELLS:
        arch, shape = cell.split(":")
        cfg = get_config(arch, smoke=True)
        model = build_model(cfg, device="meta")
        rules = make_rules(mesh, overrides=overrides_for(
            cfg, SHAPES[shape]["kind"]))
        got = dryrun.cell_bytes(model, shape, mesh, rules)["memory"]
        assert got == want[cell], cell


def test_dryrun_shadow_mesh_reached_from_the_dry_run_alone():
    """No serving or training module names the `ShadowMesh`: it is
    defined beside the live meshes and built by `launch.dryrun` alone."""
    from pathlib import Path
    port = Path(dryrun.__file__).resolve().parents[1]
    users = sorted(str(p.relative_to(port)) for p in port.rglob("*.py")
                   if "ShadowMesh" in p.read_text())
    assert users == ["launch/dryrun.py", "parallel/sharding.py"], users
