"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``; no PyTorch header is compiled, so a build takes seconds.
The build happens at first use, never at import, into ``build/`` beside
this file (listed in ``.gitignore``).  The library's name carries a hash
of its source and flags, so an edited source is rebuilt and several
processes can share one build directory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = {"conflict": _HERE / "csrc" / "conflict.cu"}
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every entry point: argtypes (each pointer and the
# stream as c_void_p, each size as c_int); all return cudaError_t as int
SIGNATURES = {
    "conflict": {
        "pot_conflict_pair": [_P, _P, _P, _I, _I, _I, _P],
        "pot_conflict_delta": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpot_{name}_{digest}.so"


def start_build(name: str):
    """Start ``nvcc`` for one source in the background.  Returns
    ``(process, temporary output path)``, or None when the library is
    already built; finish it with :func:`finish_build`."""
    if library_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def finish_build(name: str, started) -> Path:
    """Wait for a build started by :func:`start_build`; raises with the
    compiler's output if it failed."""
    out = library_path(name)
    if started is None:
        return out
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)   # atomic: concurrent builders agree
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = finish_build(name, start_build(name))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
