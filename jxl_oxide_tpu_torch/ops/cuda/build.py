"""Build a CUDA source of csrc/ into a shared library with a plain C
interface and load it with ctypes.

nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC:
no PyTorch headers, so a build takes seconds. Each library (`SOURCES`:
the EPF kernel, the modular squeeze kernel, the squeeze's chain probe, a
measurement no decode calls, and the noise field kernel) goes into the package's
gitignored `_build/` directory at first use and is rebuilt when one of its
own sources is newer. `-Xptxas -v` output (registers, shared memory,
spills) is kept beside the library as `<name>.ptxas.txt`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_ROOT, "csrc")
BUILD_DIR = os.path.join(_PKG_ROOT, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its sources in csrc/: the .cu it compiles, then headers
SOURCES = {
    "epf": ("epf.cu", "epf_math.cuh"),
    "modular_squeeze": ("modular_squeeze.cu", "squeeze_math.cuh"),
    "squeeze_probe": ("squeeze_probe.cu", "squeeze_math.cuh"),
    "noise": ("noise.cu", "noise_math.cuh"),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu into _build/lib<name>.so if it is missing or
    older than any of its SOURCES; returns the library path."""
    sources = [os.path.join(CSRC_DIR, f) for f in SOURCES[name]]
    src = sources[0]
    out = library_path(name)
    newest = max(os.path.getmtime(f) for f in sources)
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}"
        )
    with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use and loaded once."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
