"""Build-at-first-use for the port's native code: the reference's C++ BVH
builder (g++) and the CUDA traversal kernel (nvcc).

Both land in build/pbrt_tpu_torch/ beside the package and load through
ctypes with a plain C interface. A build failure raises: there is no
fallback builder and no fallback kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "pbrt_tpu_torch"
BVH_BUILDER_SRC = REPO / "pbrt_tpu" / "native" / "bvh_builder.cpp"
TRAVERSE_SRC = REPO / "pbrt_tpu_torch" / "csrc" / "bvh_traverse.cu"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}


def _compile(cmd_head, src: Path, so: Path, timeout: float) -> None:
    """Compile src into so unless so is newer; write to a private name and
    rename, so concurrent processes never load a half-written library."""
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cmd = list(cmd_head) + ["-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """Load (building if needed) 'bvh_builder' or 'bvh_traverse'."""
    with _LOCK:
        if name not in _LIBS:
            if name == "bvh_builder":
                so = BUILD_DIR / "libbvh_builder.so"
                _compile(["g++", "-O3", "-std=c++17", "-shared", "-fPIC"],
                         BVH_BUILDER_SRC, so, 240)
            elif name == "bvh_traverse":
                so = BUILD_DIR / "libbvh_traverse.so"
                nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
                if not os.path.exists(nvcc):
                    nvcc = "nvcc"
                _compile([nvcc] + NVCC_FLAGS, TRAVERSE_SRC, so, 600)
            else:
                raise KeyError(name)
            _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]
