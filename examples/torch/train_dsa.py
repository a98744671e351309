"""Train the DSA-enabled llama3.2-1b smoke model of the PyTorch port for a
few hundred steps with checkpoints: the port's train CLI,
`python -m repro_torch.launch.train`.

    PYTHONPATH=src python examples/torch/train_dsa.py [--steps 300] \
        [--device cpu] [--checkpoint-dir DIR]

It runs on the GPU unless `--device cpu` is given, and raises without one.
Checkpoints go to DIR (by default `repro_torch_ckpt` in the temporary
directory) every 50 steps.
"""
import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "src")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--arch", "llama3.2-1b", "--smoke", "--steps", str(args.steps),
           "--batch", "8", "--seq", "128",
           "--checkpoint-dir", args.checkpoint_dir,
           "--checkpoint-every", "50"]
    if args.device is not None:
        cmd += ["--device", args.device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    sys.exit(main())
