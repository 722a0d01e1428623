"""K1 of the PyTorch port (point_cloud_viewer_tpu_torch/ops/scan_cuda.py)
against the JAX Pallas scan (ops/scan_pallas.scan_1d) run in interpret
mode with small blocks, as tests/test_scan_pallas.py runs it.  Integer
scans: tolerance 0.  The CUDA kernel itself is checked against its plain
version on a card, in tests/test_torch_cuda.py."""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_viewer_tpu.ops.scan_pallas import scan_1d as jax_scan_1d
from point_cloud_viewer_tpu_torch.ops import _ext
from point_cloud_viewer_tpu_torch.ops import scan_cuda as SC

_ROWS = 8  # JAX block = 8 x 128 elements
_TILE = _ext.LOOKBACK_TILE  # the CUDA kernel's tile (lookback_scan.cuh)


@pytest.mark.parametrize("kind", ["max", "min", "sum"])
@pytest.mark.parametrize("n", [1, 5, 1023, 1024, 1025, 3 * 1024 + 17,
                               _TILE - 1, _TILE, _TILE + 1, 2 * _TILE + 5])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_matches_jax_pallas(kind, n, reverse):
    rng = np.random.default_rng(n + 7 * len(kind))
    x = rng.integers(-(10**6), 10**6, n).astype(np.int32)
    want = np.asarray(jax_scan_1d(jnp.asarray(x), kind, reverse=reverse,
                                  interpret=True, rows=_ROWS))
    got = SC.scan_1d(torch.from_numpy(x), kind, reverse)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_scan_carry_crosses_blocks():
    """A value early in the array dominates a max scan to the end, and the
    other way round for the reverse scan."""
    x = np.zeros(3 * 1024 + 17, dtype=np.int32)
    x[5] = 10**6
    assert int(SC.scan_1d(torch.from_numpy(x), "max")[-1]) == 10**6
    assert int(SC.scan_1d(torch.from_numpy(x), "max", True)[0]) == 10**6


def test_scan_rejects_bad_input():
    with pytest.raises(ValueError):
        SC.scan_1d(torch.zeros(4, dtype=torch.int64), "sum")
    with pytest.raises(ValueError):
        SC.scan_1d(torch.zeros(4, dtype=torch.int32), "prod")
    with pytest.raises(ValueError):
        SC.scan_1d(torch.zeros((2, 2), dtype=torch.int32), "sum")


def test_lookback_tile_matches_header():
    """The wrappers size the look-back scratch with LOOKBACK_TILE; the
    kernels cut tiles of kLbTile = threads x items elements."""
    with open(os.path.join(_ext.CSRC, "lookback_scan.cuh")) as f:
        text = f.read()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (kLb\w+) = (\d+);", text)}
    assert consts["kLbTile"] == _ext.LOOKBACK_TILE
    assert consts["kLbThreads"] * consts["kLbItems"] == _ext.LOOKBACK_TILE
