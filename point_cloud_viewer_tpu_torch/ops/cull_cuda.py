"""K5: the fused per-node frustum cull + LOD screen size of the viewer.

Port of point_cloud_viewer_tpu/ops/culling_pallas.py (the Pallas kernel at
culling_pallas.py:81) and of the per-node half of the lax step it stands
for (point_cloud_viewer_tpu/ops/culling.py:63-72: corners, SAT relation,
screen size, visibility, priority; the sort stays in ops/culling.py).

`cull_lod` takes one frame -- matrix (4, 4), axes (A, 3), qmin/qmax (A,)
-- or F frames -- (F, 4, 4), (F, A, 3), (F, A) -- over one node table
mins (K, 3) f32, edges (K,) f32, num_points (K,) int32, and returns
(sizes, visible, priority) of shape (K,) or (F, K): f32, bool, f32 with
-inf where not visible.  On CUDA tensors it launches csrc/cull.cu once
for all frames and counts `cull_lod.launches`; on CPU tensors it runs
`cull_lod_plain`.

`cull_lod_plain` writes every product and sum as its own elementwise op,
one corner at a time, so the two are bit-equal: no einsum or matmul,
whose association and TF32 settings are the library's.  Unlike the Pallas
kernel (fixed 32 axes, padded with [-1, 1] query ranges), the axis count
is the caller's: the cull session pads with zero axes and a (-inf, inf)
range, which never separate either (culling.py:133-144).

The kernel does less work for the same bits (csrc/cull.cu): each block
drops its frame's (-inf, inf) axes; an axis is tested on the two corners
whose projections are the least and the greatest (the smaller and the
larger term on each coordinate), falling back to all 8 corners where one
of those two is not finite; and the screen size forms each distinct
product and (x, y) partial sum once.  tests/test_torch_cull.py models
these rules in PyTorch and holds them to `cull_lod_plain` bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _ext

# Nodes per chunk of the plain version: bounds its (nodes, axes)
# temporaries to ~16 MB each.
_PLAIN_ELEMS = 1 << 22


def _corners(mins, edges):
    """The 8 corners as (x, y, z) tensors, x fastest: min + unit * edge."""
    out = []
    for c in range(8):
        out.append(tuple(mins[:, d] + float((c >> d) & 1) * edges
                         for d in range(3)))
    return out


def _plain_frame(m, axes, qmin, qmax, mins, edges, num_points):
    """One frame over one chunk of nodes -> (sizes, visible, priority)."""
    ax, ay, az = axes[:, 0], axes[:, 1], axes[:, 2]
    x_lo = x_hi = y_lo = y_hi = b_lo = b_hi = None
    for cx, cy, cz in _corners(mins, edges):
        w = ((cx * m[3, 0] + cy * m[3, 1]) + cz * m[3, 2]) + m[3, 3]
        px = (((cx * m[0, 0] + cy * m[0, 1]) + cz * m[0, 2]) + m[0, 3]) / w
        py = (((cx * m[1, 0] + cy * m[1, 1]) + cz * m[1, 2]) + m[1, 3]) / w
        px = px.clamp(-1.0, 1.0)
        py = py.clamp(-1.0, 1.0)
        proj = ((cx[:, None] * ax + cy[:, None] * ay) + cz[:, None] * az)
        if x_lo is None:
            x_lo = x_hi = px
            y_lo = y_hi = py
            b_lo = b_hi = proj
        else:
            x_lo, x_hi = torch.minimum(x_lo, px), torch.maximum(x_hi, px)
            y_lo, y_hi = torch.minimum(y_lo, py), torch.maximum(y_hi, py)
            b_lo, b_hi = torch.minimum(b_lo, proj), torch.maximum(b_hi, proj)
    sizes = (x_hi - x_lo) * (y_hi - y_lo)
    separated = ((b_lo > qmax) | (b_hi < qmin)).any(dim=1)
    visible = ~separated & (num_points > 0)
    priority = torch.where(visible, sizes, float("-inf"))
    return sizes, visible, priority


def cull_lod_plain(matrix, axes, qmin, qmax, mins, edges, num_points):
    """Plain PyTorch version of K5 (module docstring), frame by frame and
    in node chunks."""
    single = matrix.dim() == 2
    if single:
        matrix, axes, qmin, qmax = (t[None] for t in (matrix, axes, qmin,
                                                      qmax))
    frames, k = matrix.shape[0], mins.shape[0]
    dev = mins.device
    sizes = torch.empty((frames, k), dtype=torch.float32, device=dev)
    visible = torch.empty((frames, k), dtype=torch.bool, device=dev)
    priority = torch.empty((frames, k), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_ELEMS // max(1, axes.shape[1]))
    for f in range(frames):
        for lo in range(0, k, step):
            hi = min(k, lo + step)
            s, v, p = _plain_frame(matrix[f], axes[f], qmin[f], qmax[f],
                                   mins[lo:hi], edges[lo:hi],
                                   num_points[lo:hi])
            sizes[f, lo:hi], visible[f, lo:hi], priority[f, lo:hi] = s, v, p
    if single:
        return sizes[0], visible[0], priority[0]
    return sizes, visible, priority


def _check(matrix, axes, qmin, qmax, mins, edges, num_points) -> None:
    if (matrix.dim() not in (2, 3) or axes.dim() != matrix.dim()
            or mins.dim() != 2):
        raise ValueError(
            "cull_lod: matrix (4, 4) with axes (A, 3), or (F, 4, 4) with "
            f"(F, A, 3), and mins (K, 3); got {tuple(matrix.shape)}, "
            f"{tuple(axes.shape)}, {tuple(mins.shape)}")
    lead = tuple(matrix.shape[:-2])
    a, k = axes.shape[-2], mins.shape[0]
    want = {
        "matrix": (matrix, torch.float32, (*lead, 4, 4)),
        "axes": (axes, torch.float32, (*lead, a, 3)),
        "qmin": (qmin, torch.float32, (*lead, a)),
        "qmax": (qmax, torch.float32, (*lead, a)),
        "mins": (mins, torch.float32, (k, 3)),
        "edges": (edges, torch.float32, (k,)),
        "num_points": (num_points, torch.int32, (k,)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"cull_lod: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if k >= 2**31:
        raise ValueError("cull_lod: K >= 2^31 (node indices are int32)")


def cull_lod(matrix: torch.Tensor, axes: torch.Tensor, qmin: torch.Tensor,
             qmax: torch.Tensor, mins: torch.Tensor, edges: torch.Tensor,
             num_points: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 over one frame or F frames -> (sizes, visible, priority)."""
    args = (matrix, axes, qmin, qmax, mins, edges, num_points)
    _check(*args)
    if not _ext.on_cuda("cull_lod", *args):
        return cull_lod_plain(*args)
    single = matrix.dim() == 2
    frames = 1 if single else matrix.shape[0]
    a_cap, k = axes.shape[-2], mins.shape[0]
    shape = (k,) if single else (frames, k)
    sizes = torch.empty(shape, dtype=torch.float32, device=mins.device)
    visible = torch.empty(shape, dtype=torch.uint8, device=mins.device)
    priority = torch.empty(shape, dtype=torch.float32, device=mins.device)
    if frames == 0 or k == 0:
        return sizes, visible.view(torch.bool), priority
    if frames > 65535:
        raise ValueError(f"cull_lod: {frames} frames > 65535 in one launch")
    lib = _ext.lib()
    if a_cap > lib.pcv_cull_max_axes():
        raise ValueError(f"cull_lod: {a_cap} axes > "
                         f"{lib.pcv_cull_max_axes()}")
    args = [t.contiguous() for t in args]
    with _ext.device_guard(mins):
        err = lib.pcv_cull(
            *(t.data_ptr() for t in args[:4]), a_cap, frames,
            *(t.data_ptr() for t in args[4:]), k, sizes.data_ptr(),
            visible.data_ptr(), priority.data_ptr(),
            _ext.stream_ptr(mins),
        )
    _ext.check(err, "cull_lod")
    cull_lod.launches += 1
    return sizes, visible.view(torch.bool), priority


cull_lod.launches = 0
