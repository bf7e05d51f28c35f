"""Build, load and launch the hand-written CUDA kernels.

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

import torch

_HERE = Path(__file__).resolve().parent
SOURCES = {"conflict": _HERE / "csrc" / "conflict.cu",
           "kv_commit": _HERE / "csrc" / "kv_commit.cu",
           "fused_adamw": _HERE / "csrc" / "fused_adamw.cu",
           "validate": _HERE / "csrc" / "validate.cu"}
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signature of every entry point: argtypes (each pointer and the
# stream as c_void_p, each size as c_int, or c_int64 where it may pass
# 2^31); all return cudaError_t as int
SIGNATURES = {
    "conflict": {
        "pot_conflict_pair": [_P] * 4 + [_I] * 7 + [_P],
        "pot_conflict_delta": [_P] * 8 + [_I] * 5 + [_P],
        "pot_rate_lop3": [_P, _I, _I, _I, _P],
        "pot_rate_bmma": [_P, _I, _I, _I, _P],
    },
    "kv_commit": {
        "pot_kv_commit_f32": [_P] * 7 + [_I] * 4 + [_P],
        "pot_kv_commit_bf16": [_P] * 7 + [_I] * 4 + [_P],
        "pot_empty_launch": [_P],
    },
    "fused_adamw": {
        "pot_adamw_f32g": [_P] * 8 + [_L, _P],
        "pot_adamw_bf16g": [_P] * 8 + [_L, _P],
        "pot_adamw_spec": [_P] * 10 + [_L, _L, _P],
    },
    "validate": {
        "pot_validate": [_P, _P, _P, _I, _I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


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


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor (the kernel's route), False for a CPU one
    (the plain version's); raises for any other device."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no {what} kernel for device {t.device}")
    return False


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Launch entry point ``fn`` of library ``name`` on the current stream
    of ``device`` (the capturing stream while a CUDA graph is captured),
    with ``device`` made current first where it is not, so the kernel
    runs where its tensors live; raises if the launch was refused.

    This is the host path of every launch, so it does as little as it
    can: the entry point is resolved once, the device guard is entered
    only for a device that is not the current one, and the stream is
    read as a raw handle on every call."""
    f = _entries.get((name, fn))
    if f is None:
        f = _entries[(name, fn)] = getattr(load(name), fn)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = f(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = f(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
