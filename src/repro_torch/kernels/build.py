"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

`build_all()` starts one nvcc per source, all at once, and waits for them.
Libraries land in `build/kernels/` at the repository root (a directory
`.gitignore` lists), named by a hash of source and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built or
loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gvr_topk", "indexer_scores", "decode_attn", "paged_gather")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures (every pointer and the stream are c_void_p, so ctypes never
# truncates them to 32 bits)
SIGNATURES = {
    "gvr_topk": {"gvr_topk_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                                     _I, _I, _I, _P, _P, _P, _P],
                 "gvr_topk_chain_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                           _F, _F, _F, _I, _I, _I, _P, _P, _P,
                                           _P],
                 "gvr_cluster_capacity": [_I, _I, _I, _I]},
    "indexer_scores": {"indexer_scores_fma_launch": [_I, _I, _P, _P, _P, _I,
                                                     _P, _P, _I, _I, _I, _I,
                                                     _I, _I, _I, _I, _I, _P,
                                                     _P],
                       "indexer_scores_mma_launch": [_I, _P, _P, _P, _I, _P,
                                                     _P, _I, _I, _I, _I, _I,
                                                     _I, _I, _I, _I, _I, _I,
                                                     _P, _P]},
    "decode_attn": {"decode_attn_launch": [_I, _I, _I, _I, _I, _P, _P, _P, _P,
                                           _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _F, _P, _P, _P, _P]},
    "paged_gather": {"paged_gather_launch": [_P, _P, _I, _I, _I, _L, _I, _P,
                                             _P]},
}


def default_build_dir() -> Path:
    """`build/kernels/` at the repository root (src/repro_torch/kernels →
    three levels up)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the port's CUDA "
                           "kernels cannot be built")
    return found


def _lib_path(name: str, build_dir: Path) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                       + " ".join(FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"lib{name}-{h}.so"


class KernelLibraries:
    """Compiled kernel libraries of one build directory, loaded once."""

    def __init__(self, build_dir: Optional[Path] = None):
        self.build_dir = Path(build_dir) if build_dir else default_build_dir()
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.logs: Dict[str, str] = {}
        self.build_seconds: Optional[float] = None

    def build_all(self) -> Dict[str, str]:
        """Compile every missing library, one nvcc per source in parallel.
        Returns each source's compiler output (ptxas register/smem report).
        Raises with the compiler's output if any build fails."""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        todo = {n: _lib_path(n, self.build_dir) for n in SOURCES}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        procs = {}
        if todo:
            nvcc = find_nvcc()
            for name, out in todo.items():
                # a temporary of its own: other processes (the ranks of a
                # sharded run) may compile the same source into the same
                # directory at once; the last rename wins
                fd, tmp = tempfile.mkstemp(dir=self.build_dir,
                                           prefix=out.stem + ".",
                                           suffix=".tmp.so")
                os.close(fd)
                tmp = Path(tmp)
                cmd = [nvcc] + FLAGS + ["-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT,
                                                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            self.logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            else:
                tmp.replace(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        self.build_seconds = time.perf_counter() - t0
        return dict(self.logs)

    def get(self, name: str) -> ctypes.CDLL:
        """The loaded library for one source, building first if needed."""
        lib = self.libs.get(name)
        if lib is None:
            path = _lib_path(name, self.build_dir)
            if not path.exists():
                self.build_all()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self.libs[name] = lib
        return lib


# the process's loaded kernels (shared libraries stay loaded for the life
# of the process, like imported extension modules)
LIBRARIES = KernelLibraries()
