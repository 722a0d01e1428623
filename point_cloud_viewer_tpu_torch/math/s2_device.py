"""S2 leaf-cell ids and cell-union membership on the card (port of
point_cloud_viewer_tpu/math/s2_device.py:35-99 to PyTorch).

The point -> leaf-cell-id pipeline is trig-free: face selection is an
argmax, (u, v) are single IEEE divisions, the quadratic ST reprojection is
one sqrt, and the Hilbert traversal is integer table lookups.  Every step
is exact integer math or one correctly rounded IEEE f64 operation, so the
ids equal math/s2.py's host ids bit for bit, provided each step rounds on
its own.  Eager PyTorch runs one kernel an operation, so it does; this
module therefore uses no fused form (`addcmul`, `lerp`, `alpha=`,
`torch.compile`) that could contract a multiply and an add into an FMA.
CUDA's f64 division and sqrt are correctly rounded, and `torch.argmax`
returns the first maximum, as `np.argmax` does.  PyTorch's CPU f64 sqrt is
not correctly rounded: it is one ulp off on some inputs (sqrt of
2.091844451100786), and now and then, after another parallel op, one
worker thread's chunk comes out far more than one ulp off, enough to move
the floor in st_to_ij.  So on CPU tensors `_sqrt` takes numpy's sqrt, the
host's own; on the card it is `torch.sqrt`.

Ids are held as int64 bit patterns of the uint64 ids: PyTorch's uint64
lacks `<<`, `<=` and `searchsorted` on the CPU.  Shifts, `|` and the final
`<< 1 | 1` give the same bits as the host's uint64 arithmetic; faces 4 and
5 set bit 63, so every order compare and `searchsorted` runs on the ids
with bit 63 flipped (XOR `SIGN_BIT`), which maps unsigned order onto
signed order.  At the numpy boundary the caller views the result as
np.uint64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import s2

# XOR with this flips bit 63 of an int64: unsigned order becomes signed.
SIGN_BIT = -(1 << 63)


# The column of [x, y, z, -x, -y, -z] that is u's and v's numerator on each
# face, in s2.xyz_to_face_uv's table (face 0: u = y / x, v = z / x; ...);
# the denominator is always the face's major coordinate, so one division
# of the selected numerator by it is the host's division.
_UV_NUMERATOR = ((1, 2), (3, 2), (3, 4), (2, 1), (2, 3), (4, 3))
_CHUNKS = 1 + (s2.MAX_LEVEL - 1) // s2._LOOKUP_BITS  # 8 Hilbert chunks


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple:
    """s2's 1024-entry Hilbert position table, _UV_NUMERATOR, the chunk
    shifts of i and j (most significant first) and of the positions, on
    `device`."""
    k = torch.arange(_CHUNKS - 1, -1, -1, dtype=torch.int64)
    return (torch.as_tensor(s2._LOOKUP_POS, dtype=torch.int64).to(device),
            torch.tensor(_UV_NUMERATOR, dtype=torch.int64).to(device),
            (k * s2._LOOKUP_BITS).to(device),
            (k * 2 * s2._LOOKUP_BITS).to(device))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f64 sqrt on x's device (see the module
    docstring for why CPU tensors go through numpy)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _uv_to_st(w: torch.Tensor) -> torch.Tensor:
    pos = 0.5 * _sqrt(torch.clamp_min(1.0 + 3.0 * w, 0.0))
    neg = 1.0 - 0.5 * _sqrt(torch.clamp_min(1.0 - 3.0 * w, 0.0))
    return torch.where(w >= 0.0, pos, neg)


def _st_to_ij(s: torch.Tensor) -> torch.Tensor:
    scaled = torch.floor(s * float(1 << s2.MAX_LEVEL))
    return torch.clamp(scaled, 0, (1 << s2.MAX_LEVEL) - 1).to(torch.int64)


def leaf_ids(p: torch.Tensor) -> torch.Tensor:
    """(N, 3) f64 ECEF/directions -> (N,) int64 bit patterns of the uint64
    leaf (level-30) cell ids, on p's device.

    Mirrors s2.leaf_cell_ids_from_points operation for operation:
    xyz_to_face_uv (argmax face pick, first maximum on ties; u and v each
    one division), uv_to_st (quadratic, one sqrt), st_to_ij (scale + floor
    + clip), then the 4-bit Hilbert lookups of cell_id_from_face_ij, chunk
    by chunk from the most significant; the position chunks occupy
    disjoint bits, so their sum is their bitwise or."""
    lookup_pos, numerator, ij_shift, pos_shift = _tables(p.device)
    axis = torch.argmax(p.abs(), dim=1)
    major = torch.gather(p, 1, axis[:, None])
    face = torch.where(major[:, 0] >= 0, axis, axis + 3)
    uv = torch.gather(torch.cat([p, -p], dim=1), 1, numerator[face]) / major
    ij = _st_to_ij(_uv_to_st(uv))
    chunks = (ij[:, :, None] >> ij_shift) & ((1 << s2._LOOKUP_BITS) - 1)
    base = (chunks[:, 0] << (s2._LOOKUP_BITS + 2)) + (chunks[:, 1] << 2)
    bits = face & s2._SWAP
    pos = []
    for k in range(_CHUNKS):
        bits = lookup_pos[base[:, k] + bits]
        pos.append(bits >> 2)
        bits = bits & (s2._SWAP | s2._INVERT)
    cid = (face << (s2.POS_BITS - 1)) + (torch.stack(pos, dim=1)
                                         << pos_shift).sum(dim=1)
    return (cid << 1) | 1


def union_mask(p: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """(N, 3) f64 points + a union's sorted cell ranges (2, K), K > 0: the
    int64 bit patterns of the uint64 range_min and range_max -> (N,) bool
    keep.  The searchsorted mirrors CellUnion.contains_cell_ids on
    sign-flipped ids."""
    ids = leaf_ids(p) ^ SIGN_BIT
    lo, hi = ranges ^ SIGN_BIT
    pos = torch.searchsorted(lo, ids, right=True) - 1
    pos_clamped = torch.clamp(pos, 0, max(lo.shape[0] - 1, 0))
    return (pos >= 0) & (ids <= hi[pos_clamped])


def union_ranges(union, device) -> torch.Tensor:
    """A CellUnion's (2, K) range ends as int64 bit patterns on `device`."""
    ranges = np.stack([union._range_min, union._range_max]).astype(np.uint64)
    return torch.from_numpy(ranges.view(np.int64)).to(device)
