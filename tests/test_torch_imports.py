"""The PyTorch port stands alone: every `repro_torch` module imports with
`jax` and the JAX package (`repro`) blocked, no port source,
`chip_smoke.py` or example of the port (`examples/torch/`) names either, and the entry points refuse to fall back to
the CPU silently."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules), \
    sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(len(names))
"""


def test_every_port_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py"))
                                        + [ROOT / "chip_smoke.py"]
                                        + list((ROOT / "examples" / "torch")
                                               .glob("*.py"))))
def test_no_source_imports_jax_or_the_jax_package(path):
    text = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax\w*|repro)\b", text, re.M)
    assert not bad, (path, bad)


def test_build_model_defaults_to_cuda():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    cfg = get_config("llama3.2-1b", smoke=True)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_the_repository(tmp_path):
    """Alone in a directory (or with no CUDA device) the on-card script
    exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
