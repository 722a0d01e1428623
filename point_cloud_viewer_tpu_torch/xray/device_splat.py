"""The x-ray splat reductions on a PyTorch device (port of
point_cloud_viewer_tpu/xray/device_splat.py:1-199).

The host strategies (generation.py) turn the reference's per-point hash
maps (xray/src/generation.rs:99-136) into np.unique /
bincount segment reductions; these are their twins as torch ops on
`device` (no hand kernel: each is a sort, a scan or a scatter-add of the
library).  Each keeps the JAX wrapper's numpy-in, numpy-out signature and
adds `device`, resolved by device.resolve_device: "cuda" (the default)
raises without a card; "cpu" runs the same ops on CPU tensors.

Dtypes: keys, indices and integer sums are int64 on the device (no
unsigned dtype but the uint8 colors goes there; torch covers unsigned
types unevenly across versions and devices) and are cast to the JAX
outputs' dtypes on the host: u32 color sums, i32 counts.

Exactness (device_splat.py:10-25 of the JAX package):
* occupancy and color sums reduce in integers: bit-exact on every device;
* the f64 moment sums and the binned run sums are exact, so bit-equal to
  the host's np.bincount in any order of addition, when each summand is
  exact in 53 bits with a bounded exponent span (f32-precision
  intensities; heights on a fixed step such as 1/64 m).  CUDA float
  atomics add in no fixed order, so for full-f64 heights the card's sums
  may differ from the host's in the last bit and the u8 image by 1 LSB.
  On the CPU, index_add_ adds in index order, as np.bincount does.
  torch.use_deterministic_algorithms(True) raises on the card's float
  index_add_; nothing here turns it on.

The binned run sums are scatter-added on the run index, never taken as a
global cumsum difference (device_splat.py:127-133): each run's partial sums
stay bounded by the run's own magnitude.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

_Z_KEYS = 2048  # z in [0, 1024] inclusive; keys are pix * 2048 + z


def xray_occupancy_device(keys: np.ndarray, image_size: int,
                          device="cuda") -> np.ndarray:
    """Packed (pix * 2048 + z) keys -> per-pixel distinct-z-bucket counts
    (i32), bit-exact vs the host np.unique path: a stable sort, run starts,
    their cumsum, and per-pixel boundaries by searchsorted at
    arange(npx + 1) (device_splat.py:51-66, 97-111)."""
    dev = resolve_device(device)
    npx = image_size * image_size
    if len(keys) == 0:
        return np.zeros(npx, dtype=np.int32)
    # The JAX package packs the keys into u32, which wraps past image_size
    # 1448 (2^32 / 2048 = 2,097,152 pixels); the port keeps its refusal.
    if npx * _Z_KEYS > 2**32:
        raise ValueError(
            f"xray_occupancy_device: image_size {image_size} overflows the "
            f"packed u32 (pixel, z) keyspace (max 1448); use the host path"
        )
    key = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64)).to(dev)
    key = torch.sort(key, stable=True).values
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    cf = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    torch.cumsum(first.to(torch.int64), 0)])
    bounds = torch.searchsorted(
        key // _Z_KEYS, torch.arange(npx + 1, dtype=torch.int64, device=dev))
    out = cf[bounds[1:]] - cf[bounds[:-1]]
    return out.to(torch.int32).cpu().numpy()


def color_sums_device(pix: np.ndarray, color: np.ndarray, image_size: int,
                      device="cuda"):
    """-> (per-pixel u32 color sums (P, 3), i32 counts (P,)), bit-exact:
    index_add_ of the u8 colors into int64 sums (device_splat.py:70-77,
    114-122)."""
    dev = resolve_device(device)
    npx = image_size * image_size
    if len(pix) == 0:
        return np.zeros((npx, 3), np.uint32), np.zeros(npx, np.int32)
    idx = torch.from_numpy(np.ascontiguousarray(pix, dtype=np.int64)).to(dev)
    col = torch.from_numpy(np.ascontiguousarray(color, dtype=np.uint8)).to(dev)
    sums = torch.zeros((npx, 3), dtype=torch.int64, device=dev)
    sums.index_add_(0, idx, col.to(torch.int64))
    counts = torch.zeros(npx, dtype=torch.int64, device=dev)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return (sums.cpu().numpy().astype(np.uint32),
            counts.to(torch.int32).cpu().numpy())


def moment_sums_device(pix: np.ndarray, values: np.ndarray, image_size: int,
                       device="cuda"):
    """-> (i32 counts, f64 sum, f64 sum of squares) per pixel, by index_add_
    (device_splat.py:86-94, 181-199); bit-equal to the host's np.bincount
    sums under the module's exactness condition."""
    dev = resolve_device(device)
    npx = image_size * image_size
    if len(pix) == 0:
        return np.zeros(npx, np.int32), np.zeros(npx), np.zeros(npx)
    idx = torch.from_numpy(np.ascontiguousarray(pix, dtype=np.int64)).to(dev)
    val = torch.from_numpy(
        np.ascontiguousarray(values, dtype=np.float64)).to(dev)
    counts = torch.zeros(npx, dtype=torch.int64, device=dev)
    counts.index_add_(0, idx, torch.ones_like(idx))
    s1 = torch.zeros(npx, dtype=torch.float64, device=dev)
    s1.index_add_(0, idx, val)
    s2 = torch.zeros(npx, dtype=torch.float64, device=dev)
    s2.index_add_(0, idx, val * val)
    return (counts.to(torch.int32).cpu().numpy(), s1.cpu().numpy(),
            s2.cpu().numpy())


def binned_run_reduce_device(pix: np.ndarray, bins: np.ndarray,
                             vals: np.ndarray, device="cuda"):
    """The dynamic-width binned keyspace -> (run pixels (K,) i64, run counts
    (K,) i64, run value sums (K, C) f64), grouped by (pixel, bin) in
    lexicographic order, exactly np.unique(key, axis=0)'s grouping
    (device_splat.py:125-178).  Two stable sorts (bin, then pixel) order
    the rows: bins may be negative and wide, so no packed key.  Runs start
    where either key changes; counts and sums are index_add_ on the run
    index."""
    dev = resolve_device(device)
    c = vals.shape[1]
    if len(pix) == 0:
        return (
            np.empty(0, np.int64), np.empty(0, np.int64),
            np.empty((0, c), np.float64),
        )
    p = torch.from_numpy(np.ascontiguousarray(pix, dtype=np.int64)).to(dev)
    b = torch.from_numpy(np.ascontiguousarray(bins, dtype=np.int64)).to(dev)
    v = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float64)).to(dev)
    order = torch.sort(b, stable=True).indices
    order = order[torch.sort(p[order], stable=True).indices]
    p, b, v = p[order], b[order], v[order]
    starts = torch.ones_like(p, dtype=torch.bool)
    starts[1:] = (p[1:] != p[:-1]) | (b[1:] != b[:-1])
    run = torch.cumsum(starts.to(torch.int64), 0) - 1
    k = int(run[-1]) + 1
    sums = torch.zeros((k, c), dtype=torch.float64, device=dev)
    sums.index_add_(0, run, v)
    counts = torch.zeros(k, dtype=torch.int64, device=dev)
    counts.index_add_(0, run, torch.ones_like(run))
    return p[starts].cpu().numpy(), counts.cpu().numpy(), sums.cpu().numpy()
