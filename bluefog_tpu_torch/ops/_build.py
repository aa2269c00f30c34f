"""Build and bind the hand-written CUDA kernels at first use.

``nvcc`` compiles each ``bluefog_tpu_torch/csrc/*.cu`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into an object file (K1
``gossip_mix.cu``, K2 ``window_deliver.cu``, K3 ``flash_attention.cu`` and
``flash_attention_bwd.cu``), all sources at once in parallel processes, and
links them into one shared library with a plain C interface, which
:func:`load` binds with ctypes.  The library lands in
``bluefog_tpu_torch/_build/`` under a name that carries a hash of the
flags, the sources and the headers they include (``csrc/*.cuh``), so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

__all__ = ["load", "build", "build_log", "find_nvcc", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_log: str = ""


def find_nvcc() -> Optional[str]:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``, else from the
    toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    return None


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _library_path() -> Path:
    """The library's path, named by a hash of the flags and of every file
    the kernels compile from: the sources and the headers beside them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in _CSRC.iterdir()
                      if p.suffix in (".cu", ".cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libbf_torch_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: List[List[str]]) -> str:
    """Start every command at once, wait for all, raise on the first that
    failed; returns what they printed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(nvcc: str, out: Path) -> str:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # objects and library go to a private directory and the library is
    # renamed into place: a concurrent build never loads a half-written file
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(_sources(), objs)])
        lib = Path(tmp) / out.name
        log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
                          *map(str, objs)]])
        os.replace(lib, out)
    return log


def build() -> Path:
    """Compile the kernel library if its hash-named file is missing, without
    loading it (no CUDA call is made), and return its path.  A launcher
    calls this once before it starts its processes, so that they do not all
    compile it at once.  Raises ``RuntimeError`` when ``nvcc`` cannot be
    found or the build fails."""
    global _log
    with _lock:
        path = _library_path()
        if not path.exists():
            nvcc = find_nvcc()
            if nvcc is None:
                raise RuntimeError(
                    "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                    " the CUDA toolkit is needed to build the kernels")
            _log = _compile(nvcc, path)
        return path


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first call if its hash-named file is
    missing.  Raises ``RuntimeError`` when ``nvcc`` cannot be found or the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(path))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.bf_gossip_mix
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr]
        fn.restype = i32
        # K1's peer form: self, out, sw, rw, the row-address table, m, K,
        # len, dtype, vec, stream
        fn = lib.bf_gossip_mix_peer
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i64, i32, i32, ptr]
        fn.restype = i32
        fn = lib.bf_window_deliver
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_double, i32, i32, i64,
                       i32, i32, i32, ptr]
        fn.restype = i32
        # K2's peer form: x, the landing-address table, source rows,
        # deliveries, dst_weight, len, dtype, vec, accumulate, stream
        fn = lib.bf_window_deliver_peer
        fn.argtypes = [ptr, ptr, ptr, i32, ctypes.c_double, i64, i32, i32,
                       i32, ptr]
        fn.restype = i32
        # symmetric buffers: alloc(bytes, device, &ptr, handle[64]),
        # open(handle, device, &ptr), close(ptr), free(ptr)
        lib.bf_peer_alloc.argtypes = [i64, i32, ctypes.POINTER(ptr), ptr]
        lib.bf_peer_open.argtypes = [ptr, i32, ctypes.POINTER(ptr)]
        lib.bf_peer_close.argtypes = [ptr]
        lib.bf_peer_free.argtypes = [ptr]
        for name in ("bf_peer_alloc", "bf_peer_open", "bf_peer_close",
                     "bf_peer_free"):
            getattr(lib, name).restype = i32
        # K3: tensor pointers, the host int64 strides, B, H, T, D, causal,
        # scale, dtype and the stream
        tail = [ctypes.POINTER(ctypes.c_longlong), i32, i32, i32, i32, i32,
                ctypes.c_double, i32, ptr]
        for name, n_ptr in (("bf_flash_fwd", 6), ("bf_flash_bwd_dkv", 9),
                            ("bf_flash_bwd_dq", 9)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + tail
            fn.restype = i32
        _lib = lib
        return lib


def build_log() -> str:
    """What nvcc printed for the build this process ran (``-Xptxas -v``:
    registers, shared memory, spills); empty when the library was already on
    disk."""
    return _log
