"""Resuming a training run in the port, bit for bit, and the train CLI
(moved here from `test_torch_train.py`, so that no test file runs past
the tier-1 budget): 10 steps straight equal 5, a checkpoint, a restore
and 5 more; the CLI trains on the CPU with checkpoints and resumes, and
refuses to run without CUDA unless asked for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import batch_for_step
from repro_torch.launch.train import make_train_step
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, tree_map

from _train_common import setup, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parent.parent


def _train(model, params, opt, steps, start=0):
    """The JAX package's `test_system._train` in the port, at B = 2,
    S = 16 where it takes (4, 32)."""
    step_fn = make_train_step(model, adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=100))
    for s in range(start, start + steps):
        b = batch_for_step(s, vocab=model.cfg.vocab, batch=2, seq=16)
        params, opt, _ = step_fn(params, opt, b)
    return params, opt


def _copy(tree):
    return tree_map(torch.clone, tree)


def test_train_checkpoint_resume_bitexact(tmp_path):
    """10 steps straight equal 5 steps, a save, restore_latest and 5 more,
    bit for bit in the parameters and the optimizer state."""
    _, _, nparams, tm = setup("llama3.2-1b", seed=0)
    p0 = bridge.params_from_numpy(nparams)
    o0 = adamw.init(p0)
    pa, oa = _train(tm, _copy(p0), _copy(o0), steps=10)
    pb, ob = _train(tm, _copy(p0), _copy(o0), steps=5)
    ckpt.save(str(tmp_path), (pb, ob), 5)
    (pb, ob), step = ckpt.restore_latest(str(tmp_path),
                                         (_copy(p0), _copy(o0)))
    assert step == 5
    pb, ob = _train(tm, pb, ob, steps=5, start=5)
    for (path, a), (_, b) in zip(flatten_with_paths((pa, oa)),
                                 flatten_with_paths((pb, ob))):
        assert torch.equal(a, b), path


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                           "--seq", "16", *args], capture_output=True,
                          text=True, timeout=300, env=env)


def test_cli_trains_and_resumes_on_the_cpu(tmp_path):
    """--device cpu: 4 steps with a checkpoint every 2, then --resume to 6
    steps, which starts from step 4 and prints the reference's lines."""
    d = str(tmp_path / "ck")
    out = _cli("--steps", "4", "--device", "cpu", "--checkpoint-dir", d,
               "--checkpoint-every", "2")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "done" and lines[0].startswith("step    0 loss ")
    assert ckpt.all_steps(d) == [2, 4]
    out = _cli("--steps", "6", "--device", "cpu", "--checkpoint-dir", d,
               "--checkpoint-every", "2", "--resume")
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "resumed from step 4" and lines[-1] == "done"
    assert lines[1].startswith("step    5 loss ")
    assert ckpt.all_steps(d) == [2, 4, 6]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_cli_refuses_without_cuda():
    out = _cli("--steps", "1")
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
