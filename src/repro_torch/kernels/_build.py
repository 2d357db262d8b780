"""Builds the CUDA kernels of ``csrc/`` and loads them with ctypes.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface,
``build/kernels/lib<name>-<hash>.so`` under the repository root; the
hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  The flags put ``csrc/`` on the include path, so a copy
of a source compiled elsewhere (``chip_smoke.py``'s planted faults)
still finds the headers.  The libraries link the CUDA
runtime statically and share PyTorch's context and streams through the
driver.  ``function`` hands a wrapper one C entry point with its
argument types set; ``launch_counts`` is where each wrapper counts its
launches.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

# kernel name -> launches since the last reset; only a wrapper that has
# launched its kernel adds to it
launch_counts: collections.Counter = collections.Counter()

build_log: Dict[str, str] = {}     # kernel name -> nvcc's output (ptxas -v)
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    launch_counts.clear()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, the headers
    beside it and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(src: Path, out: Path) -> list:
    """The nvcc command that builds ``src`` into the library ``out``."""
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the wall seconds spent.  Raises with nvcc's output if one
    fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        procs[src.stem] = (subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            path = _lib_path(CSRC / f"{name}.cu")
            if not path.exists():
                build_all()
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """``symbol`` of ``csrc/<name>.cu``'s library, returning a C int (a
    cudaError_t), with ``argtypes`` set."""
    key = (name, symbol)
    f = _fns.get(key)
    if f is None:
        f = getattr(load(name), symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[key] = f
    return f


def swap(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Put ``lib`` in place of ``csrc/<name>.cu``'s library (the planted
    faults of ``chip_smoke.py``); returns the one it replaced."""
    old = load(name)
    with _lock:
        _libs[name] = lib
        for key in [k for k in _fns if k[0] == name]:
            del _fns[key]
    return old
