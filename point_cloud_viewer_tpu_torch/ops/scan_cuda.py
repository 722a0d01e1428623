"""K1: single-sweep 1-D prefix scans (max / min / sum, int32).

Port of point_cloud_viewer_tpu/ops/scan_pallas.py (`scan_1d`, the Pallas
kernel at scan_pallas.py:148).  On a CUDA tensor `scan_1d` launches the
hand-written kernel of csrc/scan.cu; on a CPU tensor it runs the plain
PyTorch version `scan_1d_plain`.  Both are bit-equal to
torch.cummax / cummin / cumsum and their flipped twins.

Bound: device-memory bytes, 8 B an element (i32 in, i32 out).  The kernel
is one launch (after a memset of its scratch): a decoupled look-back scan
(csrc/lookback_scan.cuh) that reads each element once and writes it once,
16 B a lane with neighbouring lanes on neighbouring addresses.
"""

from __future__ import annotations

import torch

from . import _ext

KINDS = {"max": 0, "min": 1, "sum": 2}


def scan_1d_plain(x: torch.Tensor, kind: str,
                  reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch inclusive prefix (or suffix, `reverse`) scan."""
    if reverse:
        return scan_1d_plain(x.flip(0), kind).flip(0)
    if kind == "max":
        return torch.cummax(x, 0).values
    if kind == "min":
        return torch.cummin(x, 0).values
    if kind == "sum":
        return torch.cumsum(x, 0, dtype=torch.int32)
    raise ValueError(f"unknown scan kind {kind!r}")


def scan_1d(x: torch.Tensor, kind: str, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (or suffix) scan of a 1-D int32 tensor.

    CPU tensor: `scan_1d_plain`.  CUDA tensor: the K1 kernel, on PyTorch's
    current stream (one sweep, counted in `scan_1d.launches`); a view at
    any element offset is taken as it is, with scalar loads when its base
    is not 16-B aligned."""
    if kind not in KINDS:
        raise ValueError(f"unknown scan kind {kind!r}")
    _ext.check_1d("scan_1d", x, torch.int32)
    if not _ext.on_cuda("scan_1d", x):
        return scan_1d_plain(x, kind, reverse)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _ext.lib()
    with _ext.device_guard(x):
        scratch = _ext.lookback_scratch(n, x.device)
        err = lib.pcv_scan_i32(
            x.data_ptr(), out.data_ptr(), n, KINDS[kind], int(reverse),
            scratch.data_ptr(), _ext.stream_ptr(x),
        )
    _ext.check(err, "scan_1d")
    scan_1d.launches += 1
    return out


scan_1d.launches = 0
