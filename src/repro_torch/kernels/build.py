"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  Libraries land in
``build/repro_torch_kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited kernel rebuilds and an unchanged one is
reused.  Nothing is built at import: the first launch builds its own kernel,
and ``build_all`` starts one ``nvcc`` per source, all at once.

A wrapper launches through ``CudaKernel.launch``, which raises when the C
function reports a CUDA error and counts the launch.  There is no fallback:
a kernel that does not build or launch is an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(source: str) -> Path:
    """Shared-library path for ``csrc/<source>``, keyed by the hash of that
    source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Build every source whose library is missing, one ``nvcc`` process
    per source, all running at once.  Returns source -> library path;
    raises with the compiler's output if any build fails."""
    out = {s: library_path(s) for s in sources}
    todo = [s for s, p in out.items() if not p.is_file()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for s in todo:
        tmp = out[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors: List[str] = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {s} failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[s])     # atomic: never a half-written .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def all_sources() -> List[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, Path]:
    """Build every kernel of the package in parallel (set-up time)."""
    return build(all_sources())


class CudaKernel:
    """One exported C launch function of one kernel library.

    ``launches`` counts successful launches — the serving path's proof that
    it went through the kernel; callers may reset it to 0.  The library is
    built and loaded on first use."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.repro_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            msg = self._err(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} "
                               f"({msg})")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
