"""Build the port's CUDA kernels from ``fedml_tpu_torch/csrc`` and bind them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  On first use in a
process, ``load(name)`` compiles it with ``nvcc`` for Hopper (``sm_90a``)
into ``csrc/build/lib<name>_<hash>.so`` — the hash covers the sources and
the flags, so an edited kernel is rebuilt — and opens it with ``ctypes``.
Nothing is built when a module is imported: the CPU tests import every
module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
#: ``-fmad=false``: no fma contraction, so the kernels round every product
#: and sum where their plain versions do (their fmas are written out)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's messages per kernel source (``-Xptxas -v``: registers, shared
#: memory, spills), from the build this process made or found
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this exact build exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}_{_digest(src)}.so"
    if out.exists():
        build_logs.setdefault(name, "(built earlier)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_logs[name] = proc.stdout + proc.stderr
    return out


def build_all(names: List[str]) -> Dict[str, Path]:
    """Build several kernel sources at once: one ``nvcc`` each, all
    started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def load_variant(name: str, src: str, like: ctypes.CDLL,
                 fns: Iterable[str]) -> ctypes.CDLL:
    """Another copy of a kernel source with the same C interface (an
    earlier commit's, or one with other tile sizes), compiled with these
    flags and ``csrc``'s headers into ``csrc/build/lib<name>.so`` and its
    functions ``fns`` bound with the argument and result types they have
    in ``like``, the port's own bound build.  For profiling scripts that
    time builds in turns; the port itself loads only through ``load``."""
    out = BUILD_DIR / f"lib{name}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
                           str(out), src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(out))
    for fn in fns:
        ours, theirs = getattr(like, fn), getattr(lib, fn)
        theirs.argtypes, theirs.restype = ours.argtypes, ours.restype
    return lib
