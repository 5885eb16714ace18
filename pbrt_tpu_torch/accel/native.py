"""Build-at-first-use for the port's native code: the reference's C++ BVH
builder (g++) and the CUDA kernels of csrc/ (nvcc).

All land in build/pbrt_tpu_torch/ beside the package and load through
ctypes with a plain C interface. A build failure raises: there is no
fallback builder and no fallback kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "pbrt_tpu_torch"
BVH_BUILDER_SRC = REPO / "pbrt_tpu" / "native" / "bvh_builder.cpp"
CUDA_SOURCES = {name: REPO / "pbrt_tpu_torch" / "csrc" / f"{name}.cu"
                for name in ("bvh_traverse", "instance_traverse")}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCKS = {name: threading.Lock() for name in ("bvh_builder", *CUDA_SOURCES)}
_LIBS: dict = {}


def _compile(cmd_head, src: Path, so: Path, timeout: float) -> None:
    """Compile src into so unless so is newer; write to a private name and
    rename, so concurrent processes never load a half-written library."""
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = list(cmd_head) + ["-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """Load (building if needed) 'bvh_builder' or a kernel of CUDA_SOURCES."""
    if name not in _LOCKS:
        raise KeyError(name)
    with _LOCKS[name]:
        if name not in _LIBS:
            so = BUILD_DIR / f"lib{name}.so"
            if name == "bvh_builder":
                _compile(["g++", "-O3", "-std=c++17", "-shared", "-fPIC"],
                         BVH_BUILDER_SRC, so, 240)
            else:
                nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
                if not os.path.exists(nvcc):
                    nvcc = "nvcc"
                _compile([nvcc] + NVCC_FLAGS, CUDA_SOURCES[name], so, 600)
            _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]


def load_all(names) -> dict:
    """Build and load several libraries at once, one compiler each, all
    started together -> {name: seconds until it was loaded}."""
    names = list(names)
    t0 = time.time()

    def one(name):
        load(name)
        return time.time() - t0
    with ThreadPoolExecutor(max(len(names), 1)) as ex:
        return dict(zip(names, ex.map(one, names)))
