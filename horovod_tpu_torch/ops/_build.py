"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object file (all sources at once, one ``nvcc`` each), and the objects are
linked into ONE shared library with a plain C interface, loaded with
``ctypes``. Nothing here includes PyTorch's headers, so a build takes
seconds, not minutes. The build happens on first use, never at import:
CPU-only hosts import every module of the port without a compiler.

The library is cached in the build directory under a name that carries
the hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached library. The build directory is
``$HVD_TORCH_BUILD_DIR`` or ``build/kernels`` next to the package, which
``.gitignore`` lists.

:data:`LAUNCHES` counts kernel launches: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _i32, _i64, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
_FLASH_BWD = [
    _vp, _vp, _vp, _vp,                     # q, k, v, dout
    _vp, _vp,                               # lse, delta
    _vp, _vp, _vp,                          # dq, dk, dv
    _i32, _i32, _i32, _i32,                 # B, T, H, D
    ctypes.POINTER(_i64),                   # 21 strides: (b, t, h) x 7
    _f32, _f32, _i32, _vp]                  # q scale, grad scale, causal,
                                            # stream
# C entry points of csrc/*.cu: name -> argtypes (every one returns an
# int: the cudaError_t of its launch, or for *_smem_bytes a kernel's
# dynamic shared memory).
_SIGNATURES = {
    "hvd_flash_attention_fwd": [
        _vp, _vp, _vp, _vp, _vp,            # q, k, v, out, lse (or null)
        _i32, _i32, _i32, _i32,             # B, T, H, D
        _i64, _i64, _i64,                   # q strides (b, t, h)
        _i64, _i64, _i64,                   # k strides
        _i64, _i64, _i64,                   # v strides
        _f32, _i32, _vp],                   # q scale, causal, stream
    "hvd_flash_attention_fwd_smem_bytes": [],
    "hvd_flash_bwd_dq": _FLASH_BWD,
    "hvd_flash_bwd_dkv": _FLASH_BWD,
    "hvd_flash_bwd_dq_smem_bytes": [],
    "hvd_flash_bwd_dkv_smem_bytes": [],
    "hvd_paged_decode_attention": [
        _vp, _vp, _vp,                      # q, k_pool, v_pool
        _vp, _vp, _vp,                      # tables, positions, out
        _vp, _vp, _vp,                      # tickets, part_ml, part_acc
        _i32, _i32, _i32,                   # S, H, D
        _i32, _i32, _i32,                   # block_size, max_blocks, n_blocks
        _i32, _i32, _i32, _i32,             # the split plan
        _f32, _vp],                         # scale, stream
    "hvd_conv_bn_fwd": [
        _vp, _vp, _vp, _vp,                 # x, w, a, b
        _vp, _vp, _vp, _vp,                 # y, partial sums, stats, bf16 W
        _i32, _i32, _i32,                   # M, Cin, Cout
        _i32, _i32, _i32, _i32, _vp],       # prologue, relu, Cout slice,
                                            # row runs, stream
    "hvd_conv_bn_bwd": [
        _vp, _vp, _vp,                      # x, y, dy
        _vp, _vp, _vp, _vp, _vp,            # w, a, b, ds1, ds2
        _vp, _vp, _vp,                      # dx, dw, dab
        _vp, _vp, _vp,                      # partial da/db, dw; bf16 W
        _i32, _i32, _i32,                   # M, Cin, Cout
        _i32, _i32,                         # prologue, relu
        ctypes.POINTER(_i32), _vp],         # plan (6 ints), stream
}


class LaunchCounts:
    """Plain per-kernel launch counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: Dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._n[name] = self._n.get(name, 0) + 1

    def get(self, name: str) -> int:
        with self._lock:
            return self._n.get(name, 0)

    def reset(self) -> None:
        with self._lock:
            self._n.clear()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounts()

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build_dir() -> str:
    env = os.environ.get("HVD_TORCH_BUILD_DIR")
    if env:
        return env
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(pkg_parent, "build", "kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from ops/csrc on first use")


def _sources() -> List[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return h.hexdigest()[:16]


def _run(cmd: List[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    return proc.stdout


def build() -> str:
    """Compile ``csrc/*.cu`` into the shared library (unless a library
    built from the same sources exists) and return its path. The
    compiler's output (the ``-Xptxas -v`` register, shared-memory and
    spill report) is kept beside it as ``<library>.log``."""
    srcs = _sources()
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir,
                            f"libhvd_torch_kernels-{_digest(srcs)}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        # One nvcc per source, all started together.
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", so[0],
                                 "-o", so[1]]),
                zip(srcs, objs)))
        tmp_lib = os.path.join(tmp, "lib.so")
        logs.append(_run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_lib,
                          *objs]))
        with open(lib_path + ".log", "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp_lib, lib_path)      # atomic: readers never see half
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def check_launch(err: int, what: str) -> None:
    """Raise when a kernel's launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def current_stream(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
