"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by `nvcc` for Hopper (sm_90a), one process per
source and all at once, then linked into one shared library with a plain
C interface, on first use, and loaded with ctypes.
Nothing here runs at import: the CPU tests import every module of the
package on machines without `nvcc` or a card.

* The library goes to `point_cloud_viewer_tpu_torch/_build/` (listed in
  .gitignore) and is rebuilt when any source under csrc/ is newer.
* nvcc writes to a private temp name that is then `os.replace`d into
  place, so concurrent processes never load a half-written library.
* Every C entry returns `cudaGetLastError()` after its launches;
  `check()` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from ctypes import c_char_p, c_int, c_longlong, c_void_p
from typing import NamedTuple, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libpcv_torch_kernels.so")

# Elements a tile of the look-back scan (csrc/lookback_scan.cuh kLbTile):
# K1 and K2 size their scratch with it; lib() checks the library agrees.
LOOKBACK_TILE = 8192

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (argtypes, restype).  Pointers and the stream are c_void_p (a
# plain int would be cut to 32 bits), element counts c_longlong.
_SIGNATURES = {
    "pcv_tile_elems": ([], c_int),
    "pcv_lookback_tile_elems": ([], c_int),
    "pcv_error_string": ([c_int], c_char_p),
    "pcv_scan_i32": (
        [c_void_p, c_void_p, c_longlong, c_int, c_int, c_void_p, c_void_p],
        c_int,
    ),
    "pcv_seg_start": (
        [c_void_p, c_void_p, c_longlong, c_int, c_void_p, c_void_p], c_int,
    ),
    "pcv_leaf_update": (
        [c_void_p, c_void_p, c_void_p, c_void_p, c_longlong, c_int, c_int,
         c_void_p, c_void_p],
        c_int,
    ),
    "pcv_promote_tile_rows": ([], c_int),
    "pcv_promote": (
        [c_void_p, c_void_p, c_void_p, c_longlong, c_int, c_int, c_void_p,
         c_void_p],
        c_int,
    ),
    "pcv_leaf_tile_rows": ([], c_int),
    "pcv_leaf_stage": (
        [c_void_p, c_void_p, c_void_p, c_int, c_longlong, c_longlong, c_int,
         c_int, c_int, c_int, c_int, c_void_p, c_void_p],
        c_int,
    ),
    "pcv_stream_probe": (
        [c_int, c_void_p, c_void_p, c_void_p, c_void_p, c_void_p, c_longlong,
         c_void_p],
        c_int,
    ),
    "pcv_cull_max_axes": ([], c_int),
    "pcv_cull": (
        [c_void_p, c_void_p, c_void_p, c_void_p, c_int, c_int, c_void_p,
         c_void_p, c_void_p, c_longlong, c_void_p, c_void_p, c_void_p,
         c_void_p],
        c_int,
    ),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo(NamedTuple):
    seconds: float   # nvcc wall time (0: an up-to-date library was on disk)
    log: str         # nvcc's output, with -Xptxas -v register/smem lines


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    deps = _sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return os.path.getmtime(LIB_PATH) < max(os.path.getmtime(p) for p in deps)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from csrc/ on first use"
        )
    return path


def _run(cmds: list) -> str:
    """Run the nvcc commands concurrently; raise on the first failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for cmd, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
    return "".join(logs)


def build(force: bool = False) -> BuildInfo:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale."""
    if not force and not _stale():
        return BuildInfo(0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"build.{os.getpid()}"
    tmp = f"{LIB_PATH}.{tag}"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in _sources()]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    for src, obj in zip(_sources(), objs)])
        log += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.remove(path)
    return BuildInfo(time.perf_counter() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            if handle.pcv_lookback_tile_elems() != LOOKBACK_TILE:
                raise RuntimeError(
                    f"{LIB_PATH}: look-back tile "
                    f"{handle.pcv_lookback_tile_elems()} != LOOKBACK_TILE "
                    f"{LOOKBACK_TILE}")
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = lib().pcv_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_1d(name: str, t, dtype) -> None:
    """Raise unless t is a contiguous 1-D tensor of `dtype` with n < 2^31
    (the kernels index with int32 positions)."""
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous 1-D {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )
    if t.shape[0] >= 2**31:
        raise ValueError(f"{name}: n >= 2^31 (positions are int32)")


def on_cuda(name: str, *tensors) -> bool:
    """True when all tensors lie on one CUDA device, False when all lie on
    the CPU (the plain PyTorch versions); raises on anything else."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors must all lie on one CUDA device or "
                     f"on the CPU, got {[str(t.device) for t in tensors]}")


def stream_ptr(t) -> int:
    """The cudaStream_t of PyTorch's current stream on t's device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def scratch(n: int, device):
    """int32 scratch for the tile aggregates of a three-launch sweep (K3):
    one for each of the ceil(n / tile) tiles (the kernels allocate
    nothing)."""
    import torch

    tiles = -(-n // lib().pcv_tile_elems())
    return torch.empty(tiles, dtype=torch.int32, device=device)


def lookback_scratch(n: int, device):
    """Scratch of one look-back sweep (K1, K2): a tile counter and one
    64-bit state word for each of the ceil(n / LOOKBACK_TILE) tiles.  The C
    entry clears it on the launch's stream, so torch.empty suffices."""
    import torch

    return torch.empty(-(-n // LOOKBACK_TILE) + 1, dtype=torch.int64,
                       device=device)
