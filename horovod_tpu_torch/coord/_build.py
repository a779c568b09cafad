"""Build and load the coordination plane's native core.

``csrc/coordinator.cc`` is compiled with the JAX package's flags
(``g++ -std=c++14 -O2 -fPIC -pthread -shared``) into a shared library
with a plain C interface, loaded with ``ctypes``. The compiler is the
``g++`` on ``PATH``, the system's, whose ``libstdc++`` is the one the
process (PyTorch) loads; ``$CXX`` is not read: a second toolchain that
the H100 host names in ``$CXX`` built a library that crashed at its
first stream insertion in a process that had loaded PyTorch. The build happens on first use, never at import. The library
is cached in the build directory under a name that carries the hash of
the source, the flags and the compiler's identity (its ``--version``
line), so an edited source rebuilds, an unchanged one loads the cached
library, and a build directory carried to a host with another toolchain
is never loaded there (such a library can crash in another libc). The
build directory is ``$HVD_TORCH_BUILD_DIR`` or ``build/coord`` next to
the package, which ``.gitignore`` lists.

Many processes reach the build at once (the ranks of a launched world,
the workers of a test run), so the build holds an exclusive file lock in
the build directory and writes the library under a temporary name before
an atomic rename: nobody loads a half-written file. A failed build
raises, with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(CSRC, "coordinator.cc")
CXX_FLAGS = ["-std=c++14", "-O2", "-fPIC", "-pthread", "-shared"]

_c, _i, _ll, _d, _vp = (ctypes.c_char_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double, ctypes.c_void_p)
_pll, _pi = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
# C entry points of coordinator.cc: name -> (restype, argtypes).
_SIGNATURES = {
    "hvdcoord_init": (_i, [_i, _i, _c, _i, _ll, _d, _c, _c, _i]),
    "hvdcoord_submit": (_i, [_c, _i, _i, _i, _i, _i, _pll, _vp, _ll, _i,
                             _c, _i]),
    "hvdcoord_wait": (_i, [_c, ctypes.POINTER(_vp), _pll, _pll, _c, _i]),
    "hvdcoord_free": (None, [_vp]),
    "hvdcoord_shutdown": (None, []),
    "hvdcoord_responses_received": (_ll, []),
    "hvdcoord_ops_completed": (_ll, []),
    "hvdcoord_ring_ops": (_ll, []),
    "hvdcoord_ring_bytes_sent": (_ll, []),
    "hvdcoord_mute_heartbeats": (None, [_i]),
    "hvdcoord_coord_mute_acks": (None, [_i]),
    "hvdcoord_aborted": (_i, []),
    "hvdcoord_pending_resize": (_i, [_pi, _pi, _pi]),
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def build_dir() -> str:
    env = os.environ.get("HVD_TORCH_BUILD_DIR")
    if env:
        return env
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(pkg_parent, "build", "coord")


def _compiler() -> str:
    return "g++"


@functools.lru_cache(maxsize=None)
def _compiler_identity() -> str:
    """The compiler's ``--version`` line, and this host's libc."""
    try:
        out = subprocess.run([_compiler(), "--version"],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True).stdout
    except OSError as e:
        raise RuntimeError(
            f"coordination plane build: no C++ compiler {_compiler()!r} "
            f"({e}); the plane is built from coord/csrc on first use"
        ) from None
    line = out.splitlines()[0] if out else ""
    return f"{line} | {' '.join(platform.libc_ver())}"


def _digest() -> str:
    h = hashlib.sha256(" ".join([_compiler(), _compiler_identity()]
                                + CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile ``csrc/coordinator.cc`` (unless a library built from the
    same source, flags and compiler exists) and return its path."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"libhvdcoord-{_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    with open(os.path.join(out_dir, ".coord.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(lib_path):   # another process built it
                return lib_path
            fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
            os.close(fd)
            try:
                cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE]
                proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"coordination plane build failed: "
                        f"{' '.join(cmd)}\n{proc.stdout}")
                os.replace(tmp, lib_path)   # atomic: never half a file
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded native core (built on first call)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
    return _lib
