"""Build-at-first-use for the port's native code: the C++ BVH and kd-tree
builders (csrc/bvh_builder.cpp and csrc/kdtree_builder.cpp, copies of the
reference's, built with g++) and the CUDA kernels of csrc/ (nvcc).

All land in build/pbrt_tpu_torch/ beside the package and load through
ctypes with a plain C interface. A build failure raises: there is no
fallback builder and no fallback kernel.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "pbrt_tpu_torch"
CSRC = REPO / "pbrt_tpu_torch" / "csrc"
HOST_SOURCES = {name: CSRC / f"{name}.cpp" for name in ("bvh_builder", "kdtree_builder")}
CUDA_SOURCES = {name: CSRC / f"{name}.cu"
                for name in ("bvh_traverse", "bvh4_traverse", "instance_traverse",
                             "kdtree_traverse")}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCKS = {name: threading.Lock() for name in (*HOST_SOURCES, *CUDA_SOURCES)}
_LIBS: dict = {}


def _compile(cmd_head, src: Path, so: Path, timeout: float) -> None:
    """Compile src into so unless so is newer than src and the headers of
    csrc/; write to a private name and rename, so concurrent processes never
    load a half-written library."""
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if so.exists() and so.stat().st_mtime >= newest:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = list(cmd_head) + ["-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{res.stderr}")
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """Load (building if needed) a builder of HOST_SOURCES or a kernel of
    CUDA_SOURCES."""
    if name not in _LOCKS:
        raise KeyError(name)
    with _LOCKS[name]:
        if name not in _LIBS:
            so = BUILD_DIR / f"lib{name}.so"
            if name in HOST_SOURCES:
                _compile(["g++", "-O3", "-std=c++17", "-shared", "-fPIC"],
                         HOST_SOURCES[name], so, 240)
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


def _kernel_name(mangled: str) -> str:
    """A mangled kernel name -> "name" or "name<b,...>" (its bool template
    arguments). Itanium mangling writes <length><name>, then I<args>E."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):   # a name may follow other digits
            n = int(m.group()[k:])
            name = mangled[m.end():m.end() + n]
            if name.endswith("_kernel") and len(name) == n:
                args = re.match(r"I((?:Lb[01]E)+)E", mangled[m.end() + n:])
                return name + (f"<{','.join(re.findall(r'Lb([01])E', args.group(1)))}>"
                               if args else "")
    return mangled


def kernel_resources(name: str) -> dict:
    """Per kernel of a built CUDA library, what ptxas -v reported at its
    build (kept beside it as lib<name>.log) -> {kernel: {"registers",
    "spill_stores", "spill_loads", "stack_frame", "static_smem"}} (bytes
    but registers); a kernel is named by its function and template
    arguments, e.g. "instance_kernel<1>"."""
    log = BUILD_DIR / f"lib{name}.log"
    out, cur = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)), static_smem=int(sm.group(1)) if sm else 0)
    return out
