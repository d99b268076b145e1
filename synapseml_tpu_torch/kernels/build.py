"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the directory is
git-ignored), then loaded with ``ctypes``. The hash covers the source text and
the compiler flags, so an edited source rebuilds and an unchanged one is
reused. Building happens at first use; :func:`build` compiles several
sources at once, one ``nvcc`` process each, all started together.

Nothing here runs at import time, and nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["CudaKernel", "build", "nvcc_path", "CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``,
    or ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build(names: Optional[Iterable[str]] = None, log: Optional[List[str]] = None
          ) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has no
    library for its current hash yet, all ``nvcc`` processes at once.

    Returns ``{name: library path}``. ``log`` collects each compiler's
    output (``-Xptxas -v``: registers, shared memory and spills per kernel).
    Raises ``RuntimeError`` with the compiler's output when a build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    names = list(names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        text, _ = p.communicate()
        if log is not None:
            log.append(f"== nvcc {n}.cu (exit {p.returncode})\n{text}")
        if p.returncode != 0:
            failed.append(f"{n}.cu:\n{text}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point of one ``csrc`` library, with its launch count.

    Calling the object launches the kernel on the arguments given (already
    converted to ``ctypes`` values by the module's wrapper). The C function
    returns ``cudaGetLastError()`` after its launch; a non-zero code raises.
    ``launches`` counts the successful launches since the last reset, so a
    run can show that a path really went through the kernel."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._errstr = None

    def _load(self):
        lib = ctypes.CDLL(str(build([self.source])[self.source]))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        errstr = lib.smt_error_string
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        self._fn, self._errstr = fn, errstr

    def __call__(self, *args) -> None:
        if self._fn is None:
            self._load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} "
                               f"({self._errstr(err).decode()})")
        self.launches += 1
