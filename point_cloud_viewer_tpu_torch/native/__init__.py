"""ctypes bindings for the port's host-native C++ kernels (pcv_native.cpp).

Copy of point_cloud_viewer_tpu/native/__init__.py:28-557, trimmed to the
functions the port calls and the public ones of the original: every
public function of the original is here but for the wrapper-less
decode_to_f32_relative.  The library is compiled with g++ on first use
into point_cloud_viewer_tpu_torch/_build/ (listed in .gitignore), with the
JAX package's flags (native/__init__.py:55-57), and rebuilt when the
source is newer.  Every entry point returns None when the library is
unavailable (no g++, or a build that does not load) and its caller takes
its numpy fallback, as in the JAX package; `disabled()` and a truthy
PCV_DISABLE_NATIVE (1, true, yes, on) force those fallbacks, as there.
This is host code: no entry here touches a GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pcv_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(BUILD_DIR, "libpcv_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_disabled = False
build_seconds = 0.0  # g++ wall time of this process's last build


# --- copied from point_cloud_viewer_tpu/native/__init__.py:28-46 ----------


def disabled():
    """Context manager forcing the numpy fallbacks (for baseline benches).

    PROCESS-GLOBAL and not reentrant: it flips a module flag every thread
    sees, so only use it from single-threaded bench/test code — never
    around work that overlaps viewer loaders or query workers."""
    import contextlib

    @contextlib.contextmanager
    def _ctx():
        global _disabled
        prev = _disabled
        _disabled = True
        try:
            yield
        finally:
            _disabled = prev

    return _ctx()


def _build() -> bool:
    # Compile to a private temp file and os.replace into place: another
    # process may be dlopen-ing (or already executing) the .so — writing it
    # in place would hand them a truncated library.
    global build_seconds
    tmp = f"{_SO}.build.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        "-pthread", "-o", tmp, _SRC,
    ]
    t0 = time.perf_counter()
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    finally:
        build_seconds = time.perf_counter() - t0


def build() -> float:
    """Compile the library now, even over an up-to-date one on disk, and
    return g++'s wall seconds; raises if g++ fails.  For a caller that
    wants the build out of later timings: call it before first use."""
    if not _build():
        raise RuntimeError(f"g++ could not build {_SO} from {_SRC}")
    return build_seconds


_STUB_SRC = os.path.join(_DIR, "sdl2_stub.cpp")
_STUB_SO = os.path.join(BUILD_DIR, "libsdl2_stub.so")


def sdl2_stub_path() -> str:
    """The scriptable libSDL2 double (sdl2_stub.cpp, a copy of the JAX
    package's native/sdl2_stub.cpp) compiled with g++ into BUILD_DIR with
    the flags of its tests (tests/test_sdl_stub.py), rebuilt when the
    source is newer; returns the library's path.  SdlBackend(lib_path=...)
    loads it in the tests and on the card.  Raises RuntimeError when g++
    fails."""
    with _lock:
        if (os.path.exists(_STUB_SO)
                and os.path.getmtime(_STUB_SO) >= os.path.getmtime(_STUB_SRC)):
            return _STUB_SO
        tmp = f"{_STUB_SO}.build.{os.getpid()}"
        os.makedirs(BUILD_DIR, exist_ok=True)
        try:
            subprocess.run(["g++", "-shared", "-fPIC", "-O1", "-o", tmp,
                            _STUB_SRC], check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            raise RuntimeError(f"g++ could not build {_STUB_SO}: {e}") from e
        os.replace(tmp, _STUB_SO)
        return _STUB_SO


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    # The switch of native/__init__.py:71-74, unchanged.
    if _disabled or os.environ.get("PCV_DISABLE_NATIVE", "").lower() in (
        "1", "true", "yes", "on"
    ):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            handle = ctypes.CDLL(_SO)
        except OSError:
            return None
        if handle.pcv_native_abi_version() != 5:
            return None
        _configure(handle)
        _lib = handle
        return _lib


def available() -> bool:
    return lib() is not None


def _configure(h: ctypes.CDLL) -> None:
    from ctypes import POINTER, c_double, c_float, c_int64, c_uint8, c_uint16, c_uint32, c_uint64

    h.encode_positions_u8.argtypes = [
        POINTER(c_double), POINTER(c_double), POINTER(c_double), c_int64,
        POINTER(c_uint8),
    ]
    h.encode_positions_u16.argtypes = [
        POINTER(c_double), POINTER(c_double), POINTER(c_double), c_int64,
        POINTER(c_uint16),
    ]
    h.decode_positions_u8.argtypes = [
        POINTER(c_uint8), POINTER(c_double), POINTER(c_double), c_int64,
        POINTER(c_double),
    ]
    h.decode_positions_u16.argtypes = [
        POINTER(c_uint16), POINTER(c_double), POINTER(c_double), c_int64,
        POINTER(c_double),
    ]
    h.morton_encode.argtypes = [POINTER(c_uint32), c_int64, POINTER(c_uint64)]
    h.radix_argsort_u64.argtypes = [
        POINTER(c_uint64), c_int64, POINTER(c_int64), POINTER(c_uint64),
    ]
    h.counting_argsort_i64.argtypes = [
        POINTER(c_int64), c_int64, POINTER(c_int64), c_int64,
        POINTER(c_int64),
    ]
    h.tree_levels.argtypes = [
        POINTER(c_uint64), c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_int64, POINTER(c_uint8), POINTER(c_uint8),
    ]
    h.cull_lod_select.argtypes = [
        POINTER(c_float), POINTER(c_float), POINTER(c_float), POINTER(c_float),
        c_int64, POINTER(c_float), POINTER(c_float), POINTER(ctypes.c_int32),
        c_int64, c_int64, POINTER(ctypes.c_int32), POINTER(c_float),
        POINTER(c_uint8),
    ]
    h.cull_lod_select_f64.argtypes = [
        POINTER(c_double), POINTER(c_double), POINTER(c_double),
        POINTER(c_double), c_int64, POINTER(c_double), POINTER(c_double),
        POINTER(ctypes.c_int32), c_int64, c_int64, POINTER(ctypes.c_int32),
        POINTER(c_double), POINTER(c_uint8),
    ]
    h.cull_lod_heap_f64.restype = c_int64
    h.cull_lod_heap_f64.argtypes = [
        POINTER(c_double), POINTER(c_double), POINTER(c_double),
        POINTER(c_double), c_int64, POINTER(c_double), POINTER(c_double),
        POINTER(ctypes.c_int32), POINTER(ctypes.c_int32),
        POINTER(ctypes.c_int32), ctypes.c_int32, c_int64,
        POINTER(ctypes.c_int32), POINTER(c_double),
    ]
    h.parse_octree_meta.restype = c_int64
    h.parse_octree_meta.argtypes = [
        ctypes.c_char_p, c_int64, POINTER(ctypes.c_int32), POINTER(c_double),
        POINTER(c_double), c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    h.gather_rows.argtypes = [
        ctypes.c_void_p, POINTER(c_int64), c_int64, c_int64, ctypes.c_void_p,
    ]
    h.group_levels_full.argtypes = [
        POINTER(c_uint64), POINTER(c_uint8), POINTER(c_uint8), c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, POINTER(c_int64), ctypes.c_void_p,
        POINTER(c_int64),
    ]
    h.quantize_morton.argtypes = [
        POINTER(c_double), POINTER(c_double), c_double, ctypes.c_int, c_int64,
        POINTER(c_uint64), ctypes.c_void_p,
    ]
    for name, out_t in (
        ("gather_encode_u8", c_uint8),
        ("gather_encode_u16", c_uint16),
        ("gather_encode_f32", c_float),
        ("gather_encode_f64", c_double),
    ):
        getattr(h, name).argtypes = [
            POINTER(c_double), POINTER(c_int64), POINTER(c_double),
            POINTER(c_double), POINTER(c_int64), c_int64, POINTER(out_t),
        ]


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def morton_encode(cells: np.ndarray) -> Optional[np.ndarray]:
    """(N, 3) u32 -> (N,) u64 codes, or None if the library is unavailable."""
    h = lib()
    if h is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.uint32)
    out = np.empty(len(cells), dtype=np.uint64)
    h.morton_encode(_ptr(cells, ctypes.c_uint32), len(cells), _ptr(out, ctypes.c_uint64))
    return out


def radix_argsort_u64(keys: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Stable argsort of u64 keys -> (sorted_keys, permutation), or None."""
    h = lib()
    if h is None:
        return None
    if len(keys) >= 1 << 32:
        # The kernel carries u32 permutation indices during its passes;
        # beyond 2^32 keys it would silently wrap. Callers fall back to
        # np.argsort.
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.empty(len(keys), dtype=np.int64)
    out = np.empty(len(keys), dtype=np.uint64)
    h.radix_argsort_u64(
        _ptr(keys, ctypes.c_uint64), len(keys),
        _ptr(perm, ctypes.c_int64), _ptr(out, ctypes.c_uint64),
    )
    return out, perm


# native/__init__.py:222-247, unchanged.
def encode_positions(positions, cube_min, edge, dtype) -> Optional[np.ndarray]:
    """Interleaved fixpoint encode (u8/u16 only), or None."""
    h = lib()
    if h is None:
        return None
    n = len(positions)
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    cube_min = np.ascontiguousarray(
        np.broadcast_to(cube_min, (n, 3)), dtype=np.float64
    )
    edge = np.ascontiguousarray(np.broadcast_to(edge, (n,)), dtype=np.float64)
    if dtype == np.uint8:
        out = np.empty((n, 3), dtype=np.uint8)
        h.encode_positions_u8(
            _ptr(positions, ctypes.c_double), _ptr(cube_min, ctypes.c_double),
            _ptr(edge, ctypes.c_double), n, _ptr(out, ctypes.c_uint8),
        )
        return out
    if dtype == np.uint16:
        out = np.empty((n, 3), dtype=np.uint16)
        h.encode_positions_u16(
            _ptr(positions, ctypes.c_double), _ptr(cube_min, ctypes.c_double),
            _ptr(edge, ctypes.c_double), n, _ptr(out, ctypes.c_uint16),
        )
        return out
    return None


def quantize_morton(
    positions: np.ndarray, root_min, edge: float, depth: int,
    want_cells: bool = False,
) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Fused (N,3) f64 -> u64 Morton codes (+ optional u32 cells), or None."""
    h = lib()
    if h is None:
        return None
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    n = len(positions)
    root_min = np.ascontiguousarray(root_min, dtype=np.float64)
    codes = np.empty(n, dtype=np.uint64)
    cells = np.empty((n, 3), dtype=np.uint32) if want_cells else None
    h.quantize_morton(
        _ptr(positions, ctypes.c_double), _ptr(root_min, ctypes.c_double),
        ctypes.c_double(edge), ctypes.c_int(depth), n,
        _ptr(codes, ctypes.c_uint64),
        cells.ctypes.data_as(ctypes.c_void_p) if want_cells else None,
    )
    return codes, cells


def tree_levels(
    codes: np.ndarray, depth: int, max_split_level: int, max_points: int,
    root_level: int = 0, stop_level: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-point (leaf_level, final_level) over SORTED Morton codes — host
    mirror of ops/tree_build.build_tree_device_codes; None if unavailable.
    root_level/stop_level target subtree (out-of-core bucket) builds.
    (Copied from point_cloud_viewer_tpu/native/__init__.py:272-293.)"""
    h = lib()
    if h is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    n = len(codes)
    leaf = np.empty(n, dtype=np.uint8)
    final = np.empty(n, dtype=np.uint8)
    h.tree_levels(
        _ptr(codes, ctypes.c_uint64), n, ctypes.c_int(depth),
        ctypes.c_int(root_level), ctypes.c_int(stop_level),
        ctypes.c_int(max_split_level), max_points,
        _ptr(leaf, ctypes.c_uint8), _ptr(final, ctypes.c_uint8),
    )
    return leaf, final


def cull_lod_select(
    matrix: np.ndarray, axes: np.ndarray, qmin: np.ndarray, qmax: np.ndarray,
    node_min: np.ndarray, edge: np.ndarray, num_points: np.ndarray,
    dtype=np.float32, max_out: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Host frustum cull + LOD select -> (order i32, sizes, visible bool),
    or None if the library is unavailable.  dtype: float32 or float64.
    max_out > 0: only the first max_out entries of `order` are sorted
    (top-K partial sort — viewers draw a bounded node budget)."""
    h = lib()
    if h is None:
        return None
    dtype = np.dtype(dtype)
    fn = h.cull_lod_select if dtype == np.float32 else h.cull_lod_select_f64
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_double
    matrix = np.ascontiguousarray(matrix, dtype=dtype)
    axes = np.ascontiguousarray(axes, dtype=dtype)
    qmin = np.ascontiguousarray(qmin, dtype=dtype)
    qmax = np.ascontiguousarray(qmax, dtype=dtype)
    node_min = np.ascontiguousarray(node_min, dtype=dtype)
    edge = np.ascontiguousarray(edge, dtype=dtype)
    num_points = np.ascontiguousarray(num_points, dtype=np.int32)
    k = len(edge)
    order = np.empty(k, dtype=np.int32)
    sizes = np.empty(k, dtype=dtype)
    visible = np.empty(k, dtype=np.uint8)
    fn(
        _ptr(matrix, ctype), _ptr(axes, ctype),
        _ptr(qmin, ctype), _ptr(qmax, ctype), len(axes),
        _ptr(node_min, ctype), _ptr(edge, ctype),
        _ptr(num_points, ctypes.c_int32), k, int(max_out),
        _ptr(order, ctypes.c_int32), _ptr(sizes, ctype),
        _ptr(visible, ctypes.c_uint8),
    )
    return order, sizes, visible.astype(bool)


def cull_lod_heap(
    matrix: np.ndarray, axes: np.ndarray, qmin: np.ndarray, qmax: np.ndarray,
    node_min: np.ndarray, edge: np.ndarray, num_points: np.ndarray,
    child_start: np.ndarray, child_end: np.ndarray, root: int, max_out: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Best-first heap cull (reference src/octree/mod.rs:228-283): emits at
    most `max_out` visible nonempty nodes, largest projected screen size
    first, touching only O(emitted) nodes of the tree.  Returns
    (order i32, sizes f64) of the emitted nodes, or None if the library is
    unavailable."""
    h = lib()
    if h is None:
        return None
    matrix = np.ascontiguousarray(matrix, dtype=np.float64)
    axes = np.ascontiguousarray(axes, dtype=np.float64)
    qmin = np.ascontiguousarray(qmin, dtype=np.float64)
    qmax = np.ascontiguousarray(qmax, dtype=np.float64)
    node_min = np.ascontiguousarray(node_min, dtype=np.float64)
    edge = np.ascontiguousarray(edge, dtype=np.float64)
    num_points = np.ascontiguousarray(num_points, dtype=np.int32)
    child_start = np.ascontiguousarray(child_start, dtype=np.int32)
    child_end = np.ascontiguousarray(child_end, dtype=np.int32)
    order = np.empty(max_out, dtype=np.int32)
    sizes = np.empty(max_out, dtype=np.float64)
    emitted = h.cull_lod_heap_f64(
        _ptr(matrix, ctypes.c_double), _ptr(axes, ctypes.c_double),
        _ptr(qmin, ctypes.c_double), _ptr(qmax, ctypes.c_double), len(axes),
        _ptr(node_min, ctypes.c_double), _ptr(edge, ctypes.c_double),
        _ptr(num_points, ctypes.c_int32),
        _ptr(child_start, ctypes.c_int32), _ptr(child_end, ctypes.c_int32),
        ctypes.c_int32(root), int(max_out),
        _ptr(order, ctypes.c_int32), _ptr(sizes, ctypes.c_double),
    )
    return order[:emitted], sizes[:emitted]


def parse_octree_meta(data: bytes):
    """Fast path for current-layout octree meta.pb: returns
    (version, bbox (6,) f64, resolution, id_hi u64, id_lo u64,
    num_points i64, encoding u8) or None (unsupported layout / no lib) —
    the caller falls back to the Python decoder."""
    h = lib()
    if h is None:
        return None
    version = ctypes.c_int32(0)
    bbox = (ctypes.c_double * 6)()
    resolution = ctypes.c_double(0.0)
    n = h.parse_octree_meta(
        data, len(data), ctypes.byref(version), bbox,
        ctypes.byref(resolution), 0, None, None, None, None,
    )
    if n < 0:
        return None
    id_hi = np.empty(n, dtype=np.uint64)
    id_lo = np.empty(n, dtype=np.uint64)
    num_points = np.empty(n, dtype=np.int64)
    encoding = np.empty(n, dtype=np.uint8)
    n2 = h.parse_octree_meta(
        data, len(data), ctypes.byref(version), bbox,
        ctypes.byref(resolution), n,
        id_hi.ctypes.data_as(ctypes.c_void_p),
        id_lo.ctypes.data_as(ctypes.c_void_p),
        num_points.ctypes.data_as(ctypes.c_void_p),
        encoding.ctypes.data_as(ctypes.c_void_p),
    )
    if n2 != n:
        return None
    return (
        int(version.value), np.array(bbox[:6]), float(resolution.value),
        id_hi, id_lo, num_points, encoding,
    )


def group_levels_full(
    codes: np.ndarray, final_lv: np.ndarray, leaf_lv: np.ndarray,
    depth: int, num_levels: int,
):
    """Whole builder grouping in one native pass: counting-sort by final
    level + per-level node-path runs + per-level distinct leaf prefixes.

    Returns (idx_by_level i64[n], level_starts i64[L+1],
    node_paths u64[...], node_counts i64[...], node_level_offsets i64[L+1],
    leaf_paths u64[...], leaf_level_offsets i64[L+1]) or None."""
    h = lib()
    if h is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint64)
    final_lv = np.ascontiguousarray(final_lv, dtype=np.uint8)
    leaf_lv = np.ascontiguousarray(leaf_lv, dtype=np.uint8)
    n = len(codes)
    node_cnt = np.zeros(num_levels + 1, dtype=np.int64)
    leaf_cnt = np.zeros(num_levels + 1, dtype=np.int64)
    h.group_levels_full(
        _ptr(codes, ctypes.c_uint64), _ptr(final_lv, ctypes.c_uint8),
        _ptr(leaf_lv, ctypes.c_uint8), n, ctypes.c_int(depth),
        ctypes.c_int(num_levels), None, None, None, None,
        _ptr(node_cnt, ctypes.c_int64), None,
        _ptr(leaf_cnt, ctypes.c_int64),
    )
    node_offsets = np.zeros(num_levels + 1, dtype=np.int64)
    np.cumsum(node_cnt[:num_levels], out=node_offsets[1:])
    leaf_offsets = np.zeros(num_levels + 1, dtype=np.int64)
    np.cumsum(leaf_cnt[:num_levels], out=leaf_offsets[1:])

    idx_by_level = np.empty(n, dtype=np.int64)
    level_starts = np.empty(num_levels + 1, dtype=np.int64)
    node_paths = np.empty(int(node_offsets[-1]), dtype=np.uint64)
    node_counts = np.empty(int(node_offsets[-1]), dtype=np.int64)
    leaf_paths = np.empty(int(leaf_offsets[-1]), dtype=np.uint64)
    h.group_levels_full(
        _ptr(codes, ctypes.c_uint64), _ptr(final_lv, ctypes.c_uint8),
        _ptr(leaf_lv, ctypes.c_uint8), n, ctypes.c_int(depth),
        ctypes.c_int(num_levels),
        idx_by_level.ctypes.data_as(ctypes.c_void_p),
        level_starts.ctypes.data_as(ctypes.c_void_p),
        node_paths.ctypes.data_as(ctypes.c_void_p),
        node_counts.ctypes.data_as(ctypes.c_void_p),
        _ptr(node_offsets, ctypes.c_int64),
        leaf_paths.ctypes.data_as(ctypes.c_void_p),
        _ptr(leaf_offsets, ctypes.c_int64),
    )
    return (idx_by_level, level_starts, node_paths, node_counts,
            node_offsets, leaf_paths, leaf_offsets)


def counting_argsort(ids: np.ndarray, counts: np.ndarray) -> Optional[np.ndarray]:
    """Stable argsort of small-range int keys given their histogram
    (np.bincount), identical to np.argsort(ids, kind="stable"); None when
    the library is unavailable.  O(n) with no key materialization — the
    spill pass's bucket grouping."""
    h = lib()
    if h is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty(len(ids), dtype=np.int64)
    h.counting_argsort_i64(
        _ptr(ids, ctypes.c_int64), len(ids), _ptr(counts, ctypes.c_int64),
        len(counts), _ptr(out, ctypes.c_int64),
    )
    return out


def take_rows(arr: np.ndarray, idx: np.ndarray) -> Optional[np.ndarray]:
    """out[i] = arr[idx[i]] along axis 0 (any fixed-itemsize layout), or
    None when the library is unavailable."""
    h = lib()
    if h is None:
        return None
    arr = np.ascontiguousarray(arr)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    row = int(arr.dtype.itemsize * int(np.prod(arr.shape[1:], dtype=np.int64)))
    out = np.empty((len(idx),) + arr.shape[1:], dtype=arr.dtype)
    h.gather_rows(
        arr.ctypes.data_as(ctypes.c_void_p), _ptr(idx, ctypes.c_int64),
        len(idx), row, out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


_GATHER_ENCODE = {
    np.dtype(np.uint8): ("gather_encode_u8", ctypes.c_uint8),
    np.dtype(np.uint16): ("gather_encode_u16", ctypes.c_uint16),
    np.dtype(np.float32): ("gather_encode_f32", ctypes.c_float),
    np.dtype(np.float64): ("gather_encode_f64", ctypes.c_double),
}


def gather_encode(
    positions: np.ndarray, idx: np.ndarray, node_min: np.ndarray,
    node_edge: np.ndarray, offsets: np.ndarray, dtype,
) -> Optional[np.ndarray]:
    """Fused gather + per-node fixpoint/normalized encode.

    positions: (N,3) f64 in original order; idx: (M,) i64 point indices;
    node_min: (K,3) f64; node_edge: (K,) f64; offsets: (K+1,) i64 into idx.
    Returns (M,3) encoded, or None if the library is unavailable.
    """
    h = lib()
    if h is None:
        return None
    entry = _GATHER_ENCODE.get(np.dtype(dtype))
    if entry is None:
        return None
    name, ctype = entry
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    node_min = np.ascontiguousarray(node_min, dtype=np.float64)
    node_edge = np.ascontiguousarray(node_edge, dtype=np.float64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    k = len(node_edge)
    out = np.empty((len(idx), 3), dtype=dtype)
    getattr(h, name)(
        _ptr(positions, ctypes.c_double), _ptr(idx, ctypes.c_int64),
        _ptr(node_min, ctypes.c_double), _ptr(node_edge, ctypes.c_double),
        _ptr(offsets, ctypes.c_int64), k, _ptr(out, ctype),
    )
    return out


def decode_positions(encoded, cube_min, edge) -> Optional[np.ndarray]:
    """Interleaved fixpoint decode (u8/u16 only), or None."""
    h = lib()
    if h is None:
        return None
    n = len(encoded)
    cube_min = np.ascontiguousarray(
        np.broadcast_to(cube_min, (n, 3)), dtype=np.float64
    )
    edge = np.ascontiguousarray(np.broadcast_to(edge, (n,)), dtype=np.float64)
    out = np.empty((n, 3), dtype=np.float64)
    if encoded.dtype == np.uint8:
        encoded = np.ascontiguousarray(encoded)
        h.decode_positions_u8(
            _ptr(encoded, ctypes.c_uint8), _ptr(cube_min, ctypes.c_double),
            _ptr(edge, ctypes.c_double), n, _ptr(out, ctypes.c_double),
        )
        return out
    if encoded.dtype == np.uint16:
        encoded = np.ascontiguousarray(encoded)
        h.decode_positions_u16(
            _ptr(encoded, ctypes.c_uint16), _ptr(cube_min, ctypes.c_double),
            _ptr(edge, ctypes.c_double), n, _ptr(out, ctypes.c_double),
        )
        return out
    return None
