"""Device spatial sort: cells -> Morton codes -> sorted codes and order on
a PyTorch device (port of point_cloud_viewer_tpu/ops/sort.py).

The JAX package sorts (hi, lo, idx) u32 keys with an unstable 3-key
`jax.lax.sort`; idx is unique, so a stable `torch.sort` on the int64 code
gives the same order.

Nothing in either package calls these two functions; the JAX module is
read only by its tests (ROADMAP queue 1 item 2).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import morton


def morton_sort_device(cells: np.ndarray, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) u32 cells -> (codes_sorted u64, order int64), encoded and
    sorted on `device`; bit-identical to `morton_sort_host` (sort.py:27-32)."""
    dev = resolve_device(device)
    codes = morton.morton_encode_device(morton.cells_to_tensor(cells, dev))
    codes, order = torch.sort(codes, stable=True)
    return (codes.cpu().numpy().view(np.uint64),
            order.cpu().numpy().astype(np.int64))


def morton_sort_host(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Copied from sort.py:35-38."""
    codes = morton.morton_encode(cells)
    order = np.argsort(codes, kind="stable")
    return codes[order], order
