"""Per-point query filtering on the card (port of
point_cloud_viewer_tpu/query/device_filter.py:38-202 to PyTorch): the box,
OBB, frustum, S2 cell union and WebMercatorRect masks and the attribute
interval filter, each equal bit for bit to its host twin
(math/geometry.py contains(), s2_cells/cell_union.py, math/web_mercator.py,
math/intervals.py).

Box, cell-union and interval masks are compares of exact values (the cell
union's ids come from math/s2_device.py's exact pipeline), so the card
computes them outright.  The OBB and the frustum transform each point by
an f64 matrix product, and the host mask is defined by the host's own BLAS:
no summation order on the card (cuBLAS, or eager torch on the CPU)
reproduces it in the last bit, and JAX's `p @ rot_t + translation`
(device_filter.py:45) does not either.  These two use the hybrid exact
scheme of math/web_mercator_device.py:

1. the device computes the local (OBB) or clip (frustum) coordinates and a
   bound on their error against the host's, row by row and axis by axis;
2. it classifies each row as definitely in, definitely out or uncertain;
3. if any row of the batch is uncertain, the host's own contains() computes
   the geometry mask of the whole batch.  The whole batch and not the
   uncertain rows alone: numpy sends a product of one row to gemv and one
   of more rows to gemm, and a subset may take another BLAS kernel than
   the batch did (OpenBLAS 0.3.27 on x86-64: 246 of 540 single rows of an
   OBB transform differ in the last bit from the same rows in a batch).

The error bound (Higham, Accuracy and Stability, 3.1): a three-term dot
product plus an add, in any order and with or without FMA, is within
gamma_4 * S of the exact value, where S = sum_j |p_j m_kj| + |b_k| and
gamma_4 = 4u / (1 - 4u), u = 2^-53.  Host and device are each that close,
so they differ by at most 2 gamma_4 S < 2^-50 S.  The device computes S
with the same products on |p|, |m| and |b| (itself within gamma_4 of the
exact S) and takes E = 2^-49 S + 2^-1000 (twice the need; the absolute
term covers underflow).

* OBB, host keep: |l| <= h on every axis.  With a = |l_dev|, the margin
  M = 2 (E + 2^-52 (h + a)) covers E, the rounding of h -+ M (u (h + M))
  and of M itself: a <= h - M on every axis is definitely in, a > h + M on
  some axis definitely out.
* Frustum, host keep: -1 < q_k / w < 1 for k < 3.  With the device's q, w
  and bounds Eq, Ew, a row is uncertain where q or w is not finite or
  |w| <= 2 Ew (w may change sign).  Otherwise the host's exact quotient
  r_h = q_h / w_h obeys |r_h| <= R = (|q| + Eq) / (|w| - Ew), and the
  device's exact quotient differs from it by (e_q - r_h e_w) / w, at most
  (Eq + R Ew) / |w|; each division then rounds by u |r|.  So
  D = (Eq + R Ew) / |w| + 2^-52 (R + |clip|) bounds |clip_dev - clip_host|,
  and with M = 2 D + 2^-51 a row is definitely in where every
  -1 + M < clip < 1 - M and definitely out where some clip <= -1 - M or
  >= 1 + M.  Comparisons with NaN are false, so a NaN row, or one whose
  margin overflows, falls to the uncertain band.

WebMercatorRect runs through math/web_mercator_device.py, whose band is
refined row by row (its host path is elementwise).

Two routes compute the device's classes, chosen by what the call brings:
* K8 (csrc/query_mask.cu): on a card, for a box, OBB, frustum or
  WebMercatorRect with at most 8 intervals.  One C entry a node copies the
  positions and interval columns up from a pinned buffer, classifies every
  row in one kernel with the rules above, copies one u8 code a row back and
  waits for its own stream; ctypes releases the GIL for that round trip.
  Each call in flight takes a staging set (pinned and device buffers and a
  stream, grown to the largest node seen) from a free list and returns it,
  so nodes allocate nothing and the workers' threads share no stream.
* The eager torch ops below: the S2 cell union, `device="cpu"` (the route
  the tests hold to the JAX package), more than 8 intervals, and interval
  filters without a region.
Both feed the same host refinement.  While a torch.profiler session runs,
the counters `query.mask.fused` and `query.mask.eager` count the calls of
each (utils/progress.count).

The query client's octree nodes take a third route, `NodeDecode`, where
K8 would mask them, they are not fully inside the region and the octree is
a directory: one C call (pcv_read_node_files, the GIL released) reads the
node's position file and each interval's column as stored straight into a
staging set's pinned buffer and its other attribute files into a reused
host buffer; a second (pcv_query_decode_mask) uploads the stored bytes,
decodes each row on the card bit-equal to ops/codec.decode_positions as
the host runs it for that node, classifies it by K8's rules, compacts the
rows it keeps in row order and copies back only those: their row index,
position and code.  The batch is the fetched positions with the attributes
gathered at the fetched rows.  A WebMercatorRect's band is refined on the
fetched rows; an OBB's or a frustum's needs the whole batch (see 3.
above), so the host then decodes the node from the staged bytes and
refines as above.  The counters `query.decode.card` and
`query.decode.host` count the client's nodes whose positions only the card
decoded and those the host decoded.

`point_filter_mask` returns None only where a query is host-only by
nature: a location type it does not know, or a filter attribute that is
missing or not numeric (the host path then raises its KeyError or
ValueError).  A failure on the card raises; nothing falls back.
"""

from __future__ import annotations

import errno
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..core.attributes import AttributeDataType, attribute_extension
from ..core.points_batch import PointsBatch
from ..device import resolve_device
from ..io.node_io import NodeNotFound, OnDiskDataProvider, parse_attribute_bytes
from ..math.geometry import Aabb, Frustum, Obb
from ..math.web_mercator import WebMercatorRect
from ..math.web_mercator_device import (_calibrated_delta, classify_rect,
                                        wmc_consts)
from ..ops import _ext
from ..ops.codec import PositionEncoding, decode_positions
from ..utils.progress import count, span
from .location import AllPoints, GeometryLocation

_E_REL = 2.0 ** -49      # E = _E_REL * S + _E_ABS: see the module docstring
_E_ABS = 2.0 ** -1000
_ROUND = 2.0 ** -52      # 2u: one rounding of each division or subtraction

# K8's regions and their csrc/query_mask.cu MaskKind.
_K8_KIND = {Aabb: 0, Obb: 1, Frustum: 2, WebMercatorRect: 3}


class FilterStats:
    """Thread-safe tallies of point_filter_mask's work: `rows` masked on the
    device, `uncertain` rows in a band, `refined` rows whose mask the host
    recomputed."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rows = 0
        self.uncertain = 0
        self.refined = 0

    def add(self, rows: int, uncertain: int = 0, refined: int = 0) -> None:
        with self._lock:
            self.rows += rows
            self.uncertain += uncertain
            self.refined += refined


def _box_mask(p, mins, maxs):
    return ((mins <= p) & (p < maxs)).all(dim=-1)


def _affine(p, m_t, b):
    """p @ m_t + b: the product whose rounding the bands absorb (a test
    replaces it with another summation order)."""
    return p @ m_t + b


def _error_bound(p, m_t, b):
    """E for each entry of _affine(p, m_t, b)."""
    return _affine(p.abs(), m_t.abs(), b.abs()) * _E_REL + _E_ABS


def _obb_classify(p, rot_t, translation, half_extent):
    """-> (definite_in, uncertain) of |p @ rot_t + t| <= half_extent."""
    a = _affine(p, rot_t, translation).abs()
    margin = (_error_bound(p, rot_t, translation)
              + (half_extent + a) * _ROUND) * 2.0
    definite_in = (a <= half_extent - margin).all(dim=-1)
    definite_out = (a > half_extent + margin).any(dim=-1)
    return definite_in, ~(definite_in | definite_out)


def _frustum_classify(p, m):
    """-> (definite_in, uncertain) of -1 < clip < 1, clip = q / w with
    [q | w] = p @ m[:, :3].T + m[:, 3]."""
    m_t, b = m[:, :3].T, m[:, 3]
    qw = _affine(p, m_t, b)
    e = _error_bound(p, m_t, b)
    q, w = qw[:, :3], qw[:, 3:]
    eq, ew = e[:, :3], e[:, 3:]
    aw = w.abs()
    ok = torch.isfinite(qw).all(dim=-1) & (aw > ew * 2.0)[:, 0]
    clip = q / w
    r = (q.abs() + eq) / (aw - ew)
    d = (eq + r * ew) / aw + (r + clip.abs()) * _ROUND
    margin = d * 2.0 + 2.0 ** -51
    definite_in = ok & ((clip > margin - 1.0)
                        & (clip < 1.0 - margin)).all(dim=-1)
    definite_out = ok & ((clip <= -1.0 - margin)
                         | (clip >= 1.0 + margin)).any(dim=-1)
    return definite_in, ~(definite_in | definite_out)


def _interval_mask(values, lows, highs):
    keep = torch.ones(values.shape[1], dtype=torch.bool, device=values.device)
    for i in range(values.shape[0]):
        keep = keep & (values[i] >= lows[i]) & (values[i] <= highs[i])
    return keep


def _is_cell_union(location) -> bool:
    from ..s2_cells.cell_union import CellUnion

    return isinstance(location, CellUnion) and len(location) > 0


def point_filter_mask(
    location,
    positions: np.ndarray,
    intervals: Optional[Dict[str, object]] = None,
    attributes: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
    stats: Optional[FilterStats] = None,
) -> Optional[np.ndarray]:
    """(N, 3) f64 positions -> (N,) bool keep mask computed on `device`,
    bit-equal to the host mask (location.contains and the interval
    filters), or None if the query is host-only (see the module
    docstring).  `device="cpu"` runs the same torch code on CPU tensors."""
    geometry = getattr(location, "geometry", None)
    if isinstance(location, AllPoints):
        kind = None  # no geometric test; intervals may still apply
    elif isinstance(location, GeometryLocation) and isinstance(
        geometry, (WebMercatorRect, Aabb, Obb, Frustum)
    ):
        kind = type(geometry)
    elif _is_cell_union(location):
        kind = "cell_union"
    else:
        return None  # custom location types: host only

    intervals = intervals or {}
    for name in intervals:
        data = (attributes or {}).get(name)
        if data is None or np.asarray(data).ndim != 1:
            return None  # missing attribute: let the host path raise
        if not np.issubdtype(np.asarray(data).dtype, np.number):
            return None

    pos2d = np.atleast_2d(positions)
    n = pos2d.shape[0]
    if kind is None and not intervals:
        return np.ones(n, dtype=bool)

    dev = resolve_device(device)
    names = sorted(intervals)
    if (dev.type == "cuda" and kind in _K8_KIND
            and len(names) <= _ext.QUERY_MASK_MAX_INTERVALS):
        count("query.mask.fused", 1)
        keep, uncertain = _k8_classes(kind, geometry, pos2d, names,
                                      intervals, attributes, dev)
    else:
        count("query.mask.eager", 1)
        keep, uncertain = _eager_classes(kind, location, geometry, pos2d,
                                         names, intervals, attributes, dev)
    if uncertain is None:
        if stats is not None:
            stats.add(n)
        return keep

    result = keep.copy()
    idx = np.flatnonzero(uncertain)
    refined = 0
    if len(idx) and kind is WebMercatorRect:
        result[idx] = geometry.contains(pos2d[idx])
        refined = len(idx)
    elif len(idx):
        # The whole batch, as the host computed it (see the docstring);
        # rows outside the intervals stay out.
        result[idx] = geometry.contains(pos2d)[idx]
        refined = n
    if stats is not None:
        stats.add(n, len(idx), refined)
    return result


def _eager_classes(kind, location, geometry, pos2d, names, intervals,
                   attributes, dev) -> tuple:
    """The eager torch route -> (N,) bool (definitely) in and (N,) bool
    uncertain, or None where no row can be, each within the intervals."""
    n = pos2d.shape[0]

    def f64(*arrays):
        """The arrays, flattened into one f64 upload (torch.tensor copies:
        node positions may be read-only buffers)."""
        parts = [np.asarray(a, dtype=np.float64).ravel() for a in arrays]
        return torch.tensor(parts[0] if len(parts) == 1
                            else np.concatenate(parts), device=dev)

    keep = uncertain = None
    if kind is not None:
        p = f64(pos2d).view(n, 3)
        if kind is Aabb:
            keep = _box_mask(p, *f64(geometry.mins, geometry.maxs).view(2, 3))
        elif kind is Obb:
            iso = geometry.obb_from_query
            c = f64(iso.rotation.T, iso.translation, geometry.half_extent)
            keep, uncertain = _obb_classify(p, c[:9].view(3, 3), c[9:12],
                                            c[12:])
        elif kind is Frustum:
            keep, uncertain = _frustum_classify(
                p, f64(geometry.clip_from_query).view(4, 4))
        elif kind is WebMercatorRect:
            keep, uncertain = classify_rect(geometry, p)
        else:
            from ..math.s2_device import union_mask, union_ranges

            keep = union_mask(p, union_ranges(location, dev))
    if names:
        values = f64(*(attributes[k] for k in names)).view(len(names), n)
        lows, highs = f64([intervals[k].lower_bound for k in names],
                          [intervals[k].upper_bound for k in names]).view(
                              2, len(names))
        im = _interval_mask(values, lows, highs)
        keep = im if keep is None else keep & im
        if uncertain is not None:
            uncertain = uncertain & im  # rows the intervals drop stay out
    if uncertain is None:
        return keep.cpu().numpy(), None
    both = torch.stack([keep, uncertain]).cpu().numpy()
    return both[0], both[1]


# --- K8 -----------------------------------------------------------------------


def _k8_params(kind, geometry, lows, highs, delta: float = 0.0) -> np.ndarray:
    """K8's argument struct (csrc/query_mask.cu MaskParams) as
    _ext.QUERY_MASK_PARAMS f64: the region's constants, then the lows and
    the highs of the intervals.  `delta` is a WebMercatorRect's margin."""
    out = np.zeros(_ext.QUERY_MASK_PARAMS)
    region = out[:16]
    if kind is Aabb:
        region[:6] = np.concatenate([geometry.mins, geometry.maxs])
    elif kind is Obb:
        iso = geometry.obb_from_query
        region[:15] = np.concatenate([np.asarray(iso.rotation).T.ravel(),
                                      iso.translation, geometry.half_extent])
    elif kind is Frustum:
        region[:] = np.asarray(geometry.clip_from_query).ravel()
    elif kind is WebMercatorRect:
        nw = geometry.north_west.normalized.reshape(2)
        se = geometry.south_east.normalized.reshape(2)
        region[:8] = np.concatenate([nw + delta, se - delta, nw - delta,
                                     se + delta])
        region[8:] = wmc_consts()
    else:
        raise ValueError(f"K8 has no region kind {kind!r}")
    m = _ext.QUERY_MASK_MAX_INTERVALS
    out[16:16 + len(lows)] = lows
    out[16 + m:16 + m + len(highs)] = highs
    return out


class _Staging:
    """One K8 call's buffers and stream on a card: pinned host memory for
    the input values and the codes, their device twins, grown to the
    largest node seen, and a stream of its own; for a node as stored
    (reserve_node), its bytes, its kept rows and the compacting kernel's
    scratch."""

    def __init__(self, dev: torch.device) -> None:
        self.dev = dev
        self.stream = torch.cuda.Stream(dev)
        self.values = self.rows = 0
        self.host_in = self.dev_in = self.host_codes = self.dev_codes = None
        self.node_bytes = self.node_rows = self.files_bytes = 0
        self.host_node = self.dev_node = self.host_kept = self.dev_kept = None
        self.node_view = self.kept_view = self.host_files = self.scratch = None
        self.node_args = None

    def reserve_node(self, in_bytes: int, rows: int, files: int = 0) -> None:
        """Room for in_bytes of a node as stored, for the kept rows of a
        node of `rows` rows and for `files` bytes of its other attribute
        files (pageable host memory: reused, so a read faults in no fresh
        pages).  node_view, kept_view and host_files are numpy arrays over
        the host buffers."""
        if in_bytes > self.node_bytes:
            self.host_node, self.dev_node = self._pair(in_bytes)
            self.node_view = self.host_node.numpy()
            self.node_bytes = in_bytes
        if rows > self.node_rows:
            self.host_kept, self.dev_kept = self._pair(_decode_layout(rows)[3])
            self.kept_view = self.host_kept.numpy()
            self.scratch = self._zeroed(_decode_scratch(rows))
            self.node_rows = rows
        if self.node_args is None:
            self.node_args = np.zeros(4 + 2 * _ext.QUERY_MASK_MAX_INTERVALS,
                                      dtype=np.float64)
        if files > self.files_bytes:
            self.host_files = np.empty(files, dtype=np.uint8)
            self.files_bytes = files

    def _pair(self, nbytes: int) -> tuple:
        """nbytes of pinned host memory and of device memory (u8)."""
        return (torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                torch.empty(nbytes, dtype=torch.uint8, device=self.dev))

    def _zeroed(self, words: int) -> torch.Tensor:
        """Device int64 zeros, cleared on the staging stream: the one the
        compacting kernel runs on, which leaves its scratch zero."""
        with torch.cuda.stream(self.stream):
            return torch.zeros(words, dtype=torch.int64, device=self.dev)

    def reserve(self, values: int, rows: int) -> None:
        if values > self.values:
            self.host_in = torch.empty(values, dtype=torch.float64,
                                       pin_memory=True)
            self.dev_in = torch.empty(values, dtype=torch.float64,
                                      device=self.dev)
            self.values = values
        if rows > self.rows:
            self.host_codes = torch.empty(rows, dtype=torch.uint8,
                                          pin_memory=True)
            self.dev_codes = torch.empty(rows, dtype=torch.uint8,
                                         device=self.dev)
            self.rows = rows

    def stream_ptr(self) -> int:
        return self.stream.cuda_stream


_staging_lock = threading.Lock()
_staging_free: Dict[str, list] = {}


def _take_staging(dev: torch.device) -> _Staging:
    with _staging_lock:
        free = _staging_free.get(str(dev))
        if free:
            return free.pop()
    return _Staging(dev)


def _give_staging(staging: _Staging) -> None:
    with _staging_lock:
        _staging_free.setdefault(str(staging.dev), []).append(staging)


def _k8_classes(kind, geometry, pos2d, names, intervals, attributes,
                dev) -> tuple:
    """K8's route -> (N,) bool definitely in and (N,) bool uncertain (None
    for a box, which is exact), each within the intervals, from one
    pcv_query_mask call."""
    n, k = pos2d.shape[0], len(names)
    if n == 0:
        return np.zeros(0, dtype=bool), None
    delta = 0.0
    if kind is WebMercatorRect:
        delta = _calibrated_delta(dev, fused=True)
    params = _k8_params(kind, geometry,
                        [intervals[name].lower_bound for name in names],
                        [intervals[name].upper_bound for name in names],
                        delta)
    staging = _take_staging(dev)
    try:
        staging.reserve((3 + k) * n, n)
        host = staging.host_in.numpy()
        np.copyto(host[:3 * n].reshape(n, 3), pos2d, casting="unsafe")
        for i, name in enumerate(names):
            np.copyto(host[(3 + i) * n:(4 + i) * n], attributes[name],
                      casting="unsafe")
        with _ext.device_guard(staging.dev_in):
            _ext.check(_ext.lib().pcv_query_mask(
                _K8_KIND[kind], params.ctypes.data, k, n,
                staging.host_in.data_ptr(), staging.dev_in.data_ptr(),
                staging.dev_codes.data_ptr(), staging.host_codes.data_ptr(),
                staging.stream_ptr()), "pcv_query_mask")
        codes = staging.host_codes.numpy()[:n]
        return ((codes & 1) != 0,
                None if kind is Aabb else (codes & 2) != 0)
    finally:
        _give_staging(staging)


# --- K8 on the nodes as stored ------------------------------------------------

# The interval columns K8 reads as stored (csrc/query_mask.cu ColumnType):
# the scalar types that widen to f64 exactly.
_K8_COLUMN = {
    AttributeDataType.F64: 0, AttributeDataType.F32: 1,
    AttributeDataType.U8: 2, AttributeDataType.U16: 3,
    AttributeDataType.U32: 4, AttributeDataType.I8: 5,
    AttributeDataType.I16: 6, AttributeDataType.I32: 7,
}

# ops/codec.decode_positions takes its native routine from this many rows of
# a u8 or u16 node.
_NATIVE_DECODE_ROWS = 10_000


def _decode_layout(n: int) -> tuple:
    """Byte offsets of the kept rows of a node of n rows
    (pcv_query_decode_launch's dev_out): positions, row indices, codes, and
    the size; the count is at 0."""
    return 16, 16 + 24 * n, 16 + 28 * n, 16 + 29 * n


def _decode_scratch(n: int) -> int:
    """u64 words of the compacting kernel's scratch for n rows."""
    return 2 + -(-n // _ext.QUERY_DECODE_TILE)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _host_decode_fused(encoding: PositionEncoding, n: int) -> bool:
    """Whether the host decodes a node of n rows in `encoding` with one
    rounding of t * edge + cube_min: ops/codec.decode_positions takes its
    native routine (native/pcv_native.cpp) for a u8 or u16 node of
    _NATIVE_DECODE_ROWS rows or more where the library loads, and g++
    contracts the routine's multiply-add into an FMA where the CPU has one;
    numpy's expression rounds twice."""
    from .. import native

    if (encoding not in (PositionEncoding.UINT8, PositionEncoding.UINT16)
            or n < _NATIVE_DECODE_ROWS or native.lib() is None):
        return False
    global _native_contracts
    if _native_contracts is None:
        # A fixed u16 node: 9,398 of its 30,000 values tell the two apart.
        enc = (np.arange(30_000) * 7919 % 65536).astype("<u2").reshape(-1, 3)
        cube_min = np.array([-617.3, 123.4, 1000.5])
        edge = 1234.5678901
        fused = native.decode_positions(enc, cube_min, edge)
        if fused is None:
            return False
        _native_contracts = not np.array_equal(
            fused, enc.astype(np.float64) / 65535.0 * edge + cube_min)
    return _native_contracts


_native_contracts: Optional[bool] = None


def node_decode(query, clouds, device) -> Optional["NodeDecode"]:
    """K8's route for the nodes of `query` as stored, or None where they
    stay on the host's decode: `device` is not a card, the region is not a
    box, OBB, frustum or WebMercatorRect, there are more than
    QUERY_MASK_MAX_INTERVALS intervals, or an interval is on an attribute
    the query does not fetch.  Of `clouds`, the route takes the octrees in
    a directory that hold every attribute the query fetches, its interval
    columns of _K8_COLUMN's types."""
    if device is None or resolve_device(device).type != "cuda":
        return None
    geometry = getattr(query.location, "geometry", None)
    if not (isinstance(query.location, GeometryLocation)
            and type(geometry) in _K8_KIND):
        return None
    names = sorted(query.filter_intervals)
    if len(names) > _ext.QUERY_MASK_MAX_INTERVALS:
        return None
    if query.attributes is None or not set(names) <= set(query.attributes):
        return None
    return NodeDecode(query, clouds, resolve_device(device))


class _CloudPlan:
    """What NodeDecode needs of one cloud for every node: its directory
    (`prefix`), its files' suffixes (NUL-terminated; positions and interval
    columns first), each file's bytes a row but the positions', each
    interval column's dtype and K8 type code and each other attribute's
    data type."""

    def __init__(self, cloud, names, rest) -> None:
        types = cloud.attribute_data_types
        self.prefix = cloud.data_provider.stem("")
        self.suffixes = ["." + attribute_extension(a) + "\0"
                         for a in ["position", *names, *rest]]
        self.dtypes = [types[m].numpy_dtype.newbyteorder("<") for m in names]
        self.codes = [_K8_COLUMN[types[m]] for m in names]
        self.others = [types[a] for a in rest]
        self.row_bytes = [types[a].size_bytes for a in [*names, *rest]]


class NodeDecode:
    """K8 on the nodes of one query as stored (see the module docstring):
    `takes` says whether a node goes this way, `node_points` reads, decodes
    and masks it -> the node's batch, the host route's to the bit."""

    def __init__(self, query, clouds, dev: torch.device) -> None:
        from ..octree.octree import Octree

        self.dev = dev
        self.attributes = list(dict.fromkeys(query.attributes))
        self.names = sorted(query.filter_intervals)
        self.rest = [a for a in self.attributes if a not in self.names]
        geometry = query.location.geometry
        self.geometry = geometry
        self.kind = type(geometry)
        self.code = _K8_KIND[self.kind]
        delta = (_calibrated_delta(dev, fused=True)
                 if self.kind is WebMercatorRect else 0.0)
        intervals = query.filter_intervals
        self.params = _k8_params(
            self.kind, geometry,
            [intervals[name].lower_bound for name in self.names],
            [intervals[name].upper_bound for name in self.names], delta)
        self.params_ptr = self.params.ctypes.data
        self.clouds = set()
        self.plans: Dict[int, _CloudPlan] = {}
        for cloud in clouds:
            types = getattr(cloud, "attribute_data_types", {})
            if (isinstance(cloud, Octree)
                    and isinstance(cloud.data_provider, OnDiskDataProvider)
                    and all(a in types for a in self.attributes)
                    and all(types[m] in _K8_COLUMN for m in self.names)):
                self.clouds.add(id(cloud))

    def takes(self, cloud, fully_inside: bool) -> bool:
        return not fully_inside and id(cloud) in self.clouds

    def node_points(self, cloud, node_id, stats: Optional[FilterStats] = None
                    ) -> PointsBatch:
        """The node's points in the query, under the spans `query.decode`
        (the read, and the host's decode where the band needs it) and
        `query.mask` (the round trip, the refinement and the gather)."""
        count("query.mask.fused", 1)
        plan = self.plans.get(id(cloud))
        if plan is None:
            plan = self.plans[id(cloud)] = _CloudPlan(cloud, self.names,
                                                      self.rest)
        staging = _take_staging(self.dev)
        try:
            with span("query.decode"):
                node = self._read(cloud, node_id, plan, staging)
            with span("query.mask"):
                pos, rows, codes = self._round_trip(node, plan, staging)
                keep = None if self.kind is Aabb else (codes & 2) != 0
                uncertain = 0 if keep is None else int(np.count_nonzero(keep))
                refined = 0
                if uncertain and self.kind is WebMercatorRect:
                    refined = uncertain
                    band = keep
                    keep = (codes & 1) != 0
                    keep[band] = self.geometry.contains(pos[band])
            if uncertain and refined == 0:
                # The whole batch, as the host computed it (see the module
                # docstring), from the bytes still staged.
                count("query.decode.host", 1)
                with span("query.decode"):
                    meta = node.meta
                    encoding = meta.position_encoding
                    stored = staging.node_view[:node.sizes[0]].view(
                        encoding.numpy_dtype).reshape(-1, 3)
                    whole = decode_positions(stored, meta.cube_min,
                                             meta.edge_length, encoding)
                refined = node.n
                with span("query.mask"):
                    band = keep
                    keep = (codes & 1) != 0
                    keep[band] = self.geometry.contains(whole)[rows[band]]
            else:
                count("query.decode.card", 1)
            with span("query.mask"):
                if stats is not None:
                    stats.add(node.n, uncertain, refined)
                if keep is not None and uncertain:
                    pos, rows = pos[keep], rows[keep]
                return self._gather(node, plan, pos, rows, staging)
        finally:
            _give_staging(staging)

    def _read(self, cloud, node_id, plan: _CloudPlan,
              staging: _Staging) -> "_StagedNode":
        """The node's position file and interval columns as stored into
        staging's pinned buffer, its other attribute files into staging's
        host buffer, in one pcv_read_node_files call (the GIL released
        once)."""
        meta = cloud.node_meta(node_id)
        name = str(node_id)
        staged = 1 + len(self.names)
        row_bytes = 3 * meta.position_encoding.bytes_per_coordinate
        rows = meta.num_points
        sizes, offsets = _read_node_files(
            "".join(plan.prefix + name + s for s in plan.suffixes),
            [rows * row_bytes, *(rows * b for b in plan.row_bytes)], staged,
            staging)
        n = sizes[0] // row_bytes
        if sizes[0] != n * row_bytes:
            raise ValueError(f"node {name}: {sizes[0]} bytes of positions "
                             f"are not whole rows")
        staging.reserve_node(0, n)
        return _StagedNode(meta, n, sizes, offsets)

    def _round_trip(self, node: "_StagedNode", plan: _CloudPlan,
                    staging: _Staging) -> tuple:
        """pcv_query_decode_mask on the staged node -> the kept rows'
        (k, 3) positions, (k,) i32 row indices and (k,) u8 codes."""
        meta = node.meta
        encoding = meta.position_encoding
        n, k = node.n, len(self.names)
        # The node's cube_min and edge, then the columns' (type, offset).
        args = staging.node_args
        args[:3] = meta.cube_min
        args[3] = meta.edge_length
        specs = args[4:].view(np.int64)
        specs[0:2 * k:2] = plan.codes
        specs[1:2 * k:2] = node.offsets[1:1 + k]
        in_bytes = _aligned(node.offsets[k] + node.sizes[k])
        with _ext.device_guard(staging.dev_node):
            _ext.check(_ext.lib().pcv_query_decode_mask(
                self.code, self.params_ptr, k, int(encoding),
                int(_host_decode_fused(encoding, n)), args.ctypes.data,
                args.ctypes.data + 32, n, in_bytes,
                staging.host_node.data_ptr(), staging.dev_node.data_ptr(),
                staging.dev_kept.data_ptr(), staging.host_kept.data_ptr(),
                staging.scratch.data_ptr(), staging.stream_ptr()),
                "pcv_query_decode_mask")
        out = staging.kept_view
        kept = int(out[:8].view(np.int64)[0])
        at_pos, at_rows, at_codes, _ = _decode_layout(n)
        return (out[at_pos:at_pos + 24 * kept].view(np.float64)
                .reshape(kept, 3).copy(),
                out[at_rows:at_rows + 4 * kept].view(np.int32).copy(),
                out[at_codes:at_codes + kept].copy())

    def _gather(self, node: "_StagedNode", plan: _CloudPlan, pos, rows,
                staging: _Staging) -> PointsBatch:
        """The batch: the kept positions, each attribute at the kept rows
        (from the staged bytes, which it copies)."""
        attributes = {}
        for i, m in enumerate(self.names):
            at, size = node.offsets[1 + i], node.sizes[1 + i]
            attributes[m] = staging.node_view[at:at + size].view(
                plan.dtypes[i])
        staged = 1 + len(self.names)
        for i, a in enumerate(self.rest):
            at, size = node.offsets[staged + i], node.sizes[staged + i]
            attributes[a] = parse_attribute_bytes(
                staging.host_files[at:at + size], plan.others[i])
        for a, values in attributes.items():
            if len(values) != node.n:
                raise ValueError(f"attribute '{a}' has {len(values)} "
                                 f"entries, expected {node.n}")
            attributes[a] = values[rows]
        return PointsBatch(position=pos, attributes=attributes)


class _StagedNode:
    """A node read into a staging set: its meta, n rows, and each file's
    size and byte offset in its buffer (positions and interval columns in
    the pinned one, the other attributes in the host one)."""

    __slots__ = ("meta", "n", "sizes", "offsets")

    def __init__(self, meta, n: int, sizes, offsets) -> None:
        self.meta = meta
        self.n = n
        self.sizes = sizes
        self.offsets = offsets


def _layout(sizes, staged: int) -> tuple:
    """Byte offsets of a node's files, as pcv_read_node_files lays them
    out for files of these sizes: slots of size + 1 bytes rounded up to
    16, the first `staged` one after another in the pinned buffer, the
    rest in the host buffer -> (offsets, the bytes each buffer needs)."""
    offsets, need = [], [0, 0]
    for i, size in enumerate(sizes):
        g = 0 if i < staged else 1
        offsets.append(need[g])
        need[g] += _aligned(size + 1)
    return offsets, need


def _read_node_files(paths: str, expect, staged: int, staging) -> tuple:
    """pcv_read_node_files of the files `paths` names (NUL-terminated), of
    the sizes `expect` the node's meta gives, into staging's buffers; again
    when they are too small or a file is larger -> (sizes, offsets).
    Raises NodeNotFound for a missing file and OSError for another failure
    to read one."""
    count = len(expect)
    out = np.zeros(2 * count + 2, dtype=np.int64)
    sizes = np.array(expect, dtype=np.int64)
    encoded = paths.encode()
    for _ in range(3):
        status = _ext.lib().pcv_read_node_files(
            count, staged, encoded, sizes.ctypes.data,
            staging.host_node.data_ptr() if staging.node_bytes else None,
            staging.node_bytes,
            staging.host_files.ctypes.data if staging.files_bytes else None,
            staging.files_bytes, out.ctypes.data)
        if status == 0:
            return out[:count].tolist(), out[count:2 * count].tolist()
        if status < 0:
            path = paths.split("\0")[int(np.flatnonzero(out[:count] == -1)[0])]
            if -status == errno.ENOENT:
                raise NodeNotFound(path)
            raise OSError(-status, os.strerror(-status), path)
        sizes = np.maximum(sizes, out[:count])
        need = _layout(sizes.tolist(), staged)[1]
        staging.reserve_node(need[0], 0, need[1])
    raise OSError(f"{paths.split(chr(0))[0]}: the node's files grew while "
                  f"being read")
