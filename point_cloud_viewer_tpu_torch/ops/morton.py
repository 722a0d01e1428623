"""Morton (Z-order) codes over octree cells: the host half, and the hand-off
of codes to the device as int64.

The numpy/native functions below are copied unchanged in behaviour from
point_cloud_viewer_tpu/ops/morton.py:24-141 and call the port's own native
library.  Codes are interleaved x,y,z with x most significant (the
child-index convention x<<2 | y<<1 | z of the JAX package's
octree.node_id.child_index_from_cube); a node at level L is the set of
points whose codes share a 3L-bit prefix.

Device form: a 63-bit code is one NON-NEGATIVE int64 (`codes_to_tensor`),
in place of the JAX package's (hi, lo) uint32 pair; `morton_encode_device`
makes it from cells on the device (morton.py:148-174).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import native

MAX_DEPTH = 21  # 3*21 = 63 bits in a u64 code


def quantize(positions: np.ndarray, cube_min, edge_length: float, depth: int) -> np.ndarray:
    """(N, 3) f64 -> (N, 3) uint32 cell coordinates on the 2^depth grid.

    floor((p - min) / edge * 2^depth), clipped into range.  Points exactly on
    the max face land in the last cell.
    """
    assert 0 <= depth <= MAX_DEPTH
    positions = np.asarray(positions, dtype=np.float64)
    if edge_length <= 0:
        return np.zeros((len(positions), 3), dtype=np.uint32)
    if len(positions) >= 100_000:
        out = native.quantize_morton(
            positions, np.asarray(cube_min, dtype=np.float64), float(edge_length),
            depth, want_cells=True,
        )
        if out is not None:
            return out[1]
    scale = float(1 << depth)
    t = (positions - cube_min) / edge_length
    cells = np.floor(t * scale)
    return np.clip(cells, 0, scale - 1).astype(np.uint32)


def quantize_and_encode(
    positions: np.ndarray, cube_min, edge_length: float, depth: int,
    want_cells: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused quantize + morton_encode: (N,3) f64 -> (codes u64, cells u32).

    One pass over the input via the native kernel when available (the
    separate numpy passes are ~10x slower on large clouds); `cells` is None
    unless want_cells.  Bit-identical to quantize() + morton_encode().
    """
    positions = np.asarray(positions, dtype=np.float64)
    n = len(positions)
    if edge_length <= 0:
        cells = np.zeros((n, 3), dtype=np.uint32)
        return np.zeros(n, dtype=np.uint64), (cells if want_cells else None)
    if n >= 100_000:
        out = native.quantize_morton(
            positions, np.asarray(cube_min, dtype=np.float64), float(edge_length),
            depth, want_cells=want_cells,
        )
        if out is not None:
            return out
    cells = quantize(positions, cube_min, edge_length, depth)
    return morton_encode(cells), (cells if want_cells else None)


def argsort_codes(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Stable sort of u64 Morton codes -> (sorted_codes, permutation).

    Native multi-pass radix sort when available, else np.argsort."""
    if len(codes) >= 100_000:
        out = native.radix_argsort_u64(codes)
        if out is not None:
            return out
    order = np.argsort(codes, kind="stable")
    return codes[order], order


def _spread3_u64(x: np.ndarray) -> np.ndarray:
    """Insert two zero bits between each of the low 21 bits of x (uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_encode(cells: np.ndarray) -> np.ndarray:
    """(N, 3) uint32 cell coords -> (N,) uint64 Morton codes (x msb).

    Uses the native C++ kernel when available (~50x numpy on large inputs);
    both paths are bit-identical."""
    if len(cells) >= 100_000:
        out = native.morton_encode(cells)
        if out is not None:
            return out
    return (
        (_spread3_u64(cells[:, 0]) << np.uint64(2))
        | (_spread3_u64(cells[:, 1]) << np.uint64(1))
        | _spread3_u64(cells[:, 2])
    )


# morton.py:123-132, unchanged.
def morton_decode(codes: np.ndarray, depth: int) -> np.ndarray:
    """(N,) uint64 -> (N, 3) uint32 cell coords (inverse of morton_encode)."""
    out = np.zeros((len(codes), 3), dtype=np.uint32)
    codes = codes.astype(np.uint64)
    for bit in range(depth):
        for axis, shift in ((0, 2), (1, 1), (2, 0)):
            out[:, axis] |= (
                ((codes >> np.uint64(3 * bit + shift)) & np.uint64(1)) << np.uint32(bit)
            ).astype(np.uint32)
    return out


def split_u64(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """u64 -> (hi, lo) uint32 pair for device-side lexicographic sorting."""
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


# ---------------------------------------------------------------------------
# Device hand-off (new in the port)


def check_codes(codes_u64: np.ndarray) -> np.ndarray:
    """Contiguous uint64 codes; raises unless every code is < 2^63."""
    codes_u64 = np.ascontiguousarray(codes_u64, dtype=np.uint64)
    if len(codes_u64) and int(codes_u64.max()) >> 63:
        raise ValueError("Morton codes must fit in 63 bits")
    return codes_u64


def codes_to_tensor(codes_u64: np.ndarray, device) -> torch.Tensor:
    """Host uint64 Morton codes (< 2^63) -> non-negative int64 tensor on
    `device`.  The bit pattern is reinterpreted, not converted."""
    return torch.from_numpy(check_codes(codes_u64).view(np.int64)).to(device)


def from_jax_halves(hi: np.ndarray, lo: np.ndarray) -> torch.Tensor:
    """The JAX package's u32 (hi, lo) code halves -> the port's int64 codes
    (CPU tensor).  Its pad sentinels (hi = lo = 0xFFFFFFFF) become -1; the
    port's grouped core never reads the values of rows >= n_real."""
    joined = join_u64(np.asarray(hi), np.asarray(lo))
    return torch.from_numpy(np.ascontiguousarray(joined).view(np.int64))


# ---------------------------------------------------------------------------
# Device encode (port of point_cloud_viewer_tpu/ops/morton.py:148-174)

# `_spread3_u64`'s masks: each fits in 63 bits, so int64 holds them as is.
_SPREAD_STEPS = ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                 (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                 (2, 0x1249249249249249))


def cells_to_tensor(cells_u32: np.ndarray, device) -> torch.Tensor:
    """Host (N, 3) uint32 cells -> (N, 3) int32 tensor on `device`, the
    bits reinterpreted (12 B a point up; `morton_encode_device` reads the
    low `depth` <= 21 bits of each, so the sign never shows)."""
    cells = np.ascontiguousarray(cells_u32, dtype=np.uint32).reshape(-1, 3)
    return torch.from_numpy(cells.view(np.int32)).to(device)


def _spread3_device(v: torch.Tensor) -> torch.Tensor:
    """int64 values < 2^21 -> two zero bits between each bit, as
    `_spread3_u64`."""
    for shift, mask in _SPREAD_STEPS:
        v = (v | (v << shift)) & mask
    return v


def morton_encode_device(cells: torch.Tensor,
                         depth: int = MAX_DEPTH) -> torch.Tensor:
    """(N, 3) integer cells -> (N,) int64 Morton codes (x msb) on the
    cells' device: `join_u64` of the JAX (hi, lo) pair, bit for bit.

    As the JAX unrolled loop (morton.py:148-168), only the low `depth` bits
    of each coordinate count; they are spread with the magic numbers of
    `_spread3_u64`, five shift/or/and steps an axis in place of 3 * depth
    single-bit steps."""
    if cells.dim() != 2 or cells.shape[1] != 3:
        raise ValueError(f"cells must be (N, 3), got {tuple(cells.shape)}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth {depth} outside [0, {MAX_DEPTH}]")
    if cells.dtype.is_floating_point or cells.dtype == torch.bool:
        raise ValueError(f"cells must be integers, got {cells.dtype}")
    low = (1 << depth) - 1
    spread = [_spread3_device(cells[:, axis].to(torch.int64) & low)
              for axis in range(3)]
    return (spread[0] << 2) | (spread[1] << 1) | spread[2]


def sort_by_codes_device(codes: torch.Tensor, *values: torch.Tensor):
    """Sort by int64 code carrying `values` along; returns (codes_sorted,
    *values_sorted).  Stable: the JAX 2-key sort (morton.py:171-174) leaves
    equal codes in any order, this one in index order."""
    codes_sorted, perm = torch.sort(codes, stable=True)
    return (codes_sorted, *(v[perm] for v in values))
