"""X-ray tile generation: coloring strategies as vectorized splat kernels.

The reference accumulates per-pixel hash maps point by point
(xray/src/generation.rs:99-405); here each strategy is a segment reduction
over discretized (pixel, z-bucket / bin) keys — one np.unique + bincount
pass per tile, the same shape as a device scatter-add.  Semantics preserved:

* discretization: x = trunc((px-min)/diag * size), y flipped (image origin
  top-left), z into 1024 buckets (generation.rs:108-127);
* XRay: saturation = ln(#occupied z buckets)/ln(1024), gray = (1-s)*255;
* Colored / Intensity: per-(pixel, bin) means, then mean over bins;
* HeightStddev: population stddev of z clamped to max_stddev -> colormap;
* pixels without points are transparent; a later pass assigns the tile
  background color to pixels with alpha < 128.

Port of point_cloud_viewer_tpu/xray/generation.py:1-361.  `discretize`
and the host reductions are unchanged (host f64, numpy).  Each strategy
takes `device` in place of the JAX package's `device: bool`: a PyTorch
device ("cuda", the default, raises without a card; "cpu" runs the same
torch ops on CPU tensors), resolved when the strategy is made, or None for
the numpy route.  The device routes call device_splat's torch reductions.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np

from ..core.points_batch import PointsBatch
from ..device import resolve_device
from ..math.geometry import Aabb
from . import colormap as cm
from .device_splat import (
    _Z_KEYS,
    binned_run_reduce_device,
    color_sums_device,
    moment_sums_device,
    xray_occupancy_device,
)

NUM_Z_BUCKETS = 1024.0


def discretize(
    positions: np.ndarray, bbox: Aabb, image_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) -> (pixel keys (M,), kept-point indices (M,)).  Pixel key =
    y * image_size + x.  Points that discretize outside [0, size) are
    dropped (they would land in never-read hash slots in the reference)."""
    diag = bbox.diag()
    with np.errstate(invalid="ignore", divide="ignore"):
        x = ((positions[:, 0] - bbox.mins[0]) / diag[0] * image_size).astype(np.int64)
        y = ((1.0 - (positions[:, 1] - bbox.mins[1]) / diag[1]) * image_size).astype(
            np.int64
        )
        z = ((positions[:, 2] - bbox.mins[2]) / diag[2] * NUM_Z_BUCKETS).astype(
            np.int64
        )
    keep = (x >= 0) & (x < image_size) & (y >= 0) & (y < image_size)
    idx = np.nonzero(keep)[0]
    return (y[idx] * image_size + x[idx], np.clip(z[idx], 0, int(NUM_Z_BUCKETS)), idx)


def _resolve(device):
    """None (the numpy route) or the resolved torch.device."""
    return None if device is None else resolve_device(device)


class ColoringStrategy:
    """Accumulates point batches for one tile, then renders RGBA pixels."""

    attributes: Sequence[str] = ()

    def process(self, batch: PointsBatch, bbox: Aabb, image_size: int) -> None:
        raise NotImplementedError

    def render(self, image_size: int) -> np.ndarray:
        """-> (size, size, 4) u8 RGBA; untouched pixels transparent."""
        raise NotImplementedError


class XRayStrategy(ColoringStrategy):
    """Density: gray level from the log-count of occupied z buckets.

    With a `device` the occupancy reduction (sort, run starts, cumsum,
    searchsorted) runs there as torch ops, bit-exact vs the host
    unique/bincount path (integer counts); None is the numpy route."""

    def __init__(self, device="cuda") -> None:
        self._keys = []
        self.device = _resolve(device)

    def process(self, batch, bbox, image_size):
        pix, z, idx = discretize(batch.position, bbox, image_size)
        self._keys.append(pix * 2048 + z)

    def _occupancy(self, image_size):
        """-> (occupied pixel ids, distinct-z counts)."""
        keys_all = np.concatenate(self._keys)
        # The device route keeps the JAX package's u32 (pixel, z) keyspace:
        # pow-2 tiles <= 1024 px (the reference's range) fit; anything
        # larger stays on host.
        if (self.device is not None
                and image_size * image_size * _Z_KEYS <= 2**32):
            counts = xray_occupancy_device(keys_all, image_size, self.device)
            pix = np.nonzero(counts)[0]
            return pix, counts[pix]
        keys = np.unique(keys_all)  # distinct (pixel, z)
        return np.unique(keys // 2048, return_counts=True)

    def render(self, image_size):
        img = np.zeros((image_size * image_size, 4), dtype=np.uint8)
        if self._keys:
            pix, counts = self._occupancy(image_size)
            saturation = np.log(counts.astype(np.float64)) / np.log(NUM_Z_BUCKETS)
            # A pixel spanning the full z range occupies 1025 distinct
            # buckets (z in [0, 1024] inclusive, like the reference's
            # truncating cast), so saturation can slightly exceed 1; Rust's
            # `as u8` saturates the negative result to 0 where numpy would
            # wrap — clip to match (xray/src/generation.rs XRay::render).
            value = np.clip((1.0 - saturation) * 255.0, 0.0, 255.0).astype(np.uint8)
            img[pix, 0] = value
            img[pix, 1] = value
            img[pix, 2] = value
            img[pix, 3] = 255
        return img.reshape(image_size, image_size, 4)


def _binning_values(batch: PointsBatch, binning, idx: np.ndarray) -> np.ndarray:
    if binning is None:
        return np.zeros(len(idx), dtype=np.int64)
    name, size = binning
    data = batch.attributes.get(name)
    if data is None:
        raise KeyError("Binning attribute needs to be available in points batch.")
    return (data[idx].astype(np.float64) / size).astype(np.int64)


class _MeanOverBinsStrategy(ColoringStrategy):
    """Shared machinery: per-(pixel, bin) means of a value vector, then the
    mean over bins per pixel.

    With a `device` the O(N) per-(pixel, bin) reduction runs there: dense
    index_add_ sums when binning is None, a sorted run reduction
    (device_splat.binned_run_reduce_device) for the dynamic-width binned
    keyspace; only the tiny per-pixel mean-over-bins epilogue stays on
    host (bit-identical order to the host path).  None is the numpy
    route."""

    def __init__(self, binning=None, channels: int = 1,
                 device="cuda") -> None:
        self.binning = binning
        self.channels = channels
        self.device = _resolve(device)
        self._pix = []
        self._bin = []
        self._val = []  # (M, channels)

    def _accumulate(self, batch, bbox, image_size, values) -> None:
        pix, _, idx = discretize(batch.position, bbox, image_size)
        if len(idx) == 0:
            # reshape(0, -1) cannot infer the trailing axis; a batch with
            # no in-bounds points simply contributes nothing.
            return
        self._pix.append(pix)
        self._bin.append(_binning_values(batch, self.binning, idx))
        self._val.append(np.atleast_2d(values[idx].reshape(len(idx), -1)))

    def _pixel_means(self, image_size: int):
        """-> (pixels (K,), means (K, channels)) mean-over-bins values."""
        if not self._pix:
            return np.empty(0, np.int64), np.empty((0, self.channels))
        if self.device is not None:
            return self._pixel_means_device(image_size)
        pix = np.concatenate(self._pix)
        bins = np.concatenate(self._bin)
        vals = np.concatenate(self._val, axis=0).astype(np.float64)
        # Group by (pixel, bin).
        key = np.stack([pix, bins], axis=1)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        counts = np.bincount(inv)
        sums = np.stack(
            [np.bincount(inv, weights=vals[:, c]) for c in range(vals.shape[1])],
            axis=1,
        )
        bin_means = sums / counts[:, None]
        # Mean over bins per pixel.
        pix_ids, pinv = np.unique(uniq[:, 0], return_inverse=True)
        pcounts = np.bincount(pinv)
        psums = np.stack(
            [np.bincount(pinv, weights=bin_means[:, c]) for c in range(vals.shape[1])],
            axis=1,
        )
        return pix_ids, psums / pcounts[:, None]

    def _pixel_means_device(self, image_size: int):
        """Device (torch) twin of _pixel_means: integer-exact color sums,
        f64 moment sums — bit-equal to the host reductions (device_splat
        exactness note).  Binned keyspaces route through the sorted run
        reduction; the per-pixel mean-over-bins epilogue below repeats the
        host path's np.unique/bincount order exactly."""
        pix = np.concatenate(self._pix)
        vals = np.concatenate(self._val, axis=0).astype(np.float64)
        if self.binning is not None:
            bins = np.concatenate(self._bin)
            run_pix, run_counts, run_sums = binned_run_reduce_device(
                pix, bins, vals, self.device
            )
            bin_means = run_sums / run_counts[:, None]
            pix_ids, pinv = np.unique(run_pix, return_inverse=True)
            pcounts = np.bincount(pinv)
            psums = np.stack(
                [
                    np.bincount(pinv, weights=bin_means[:, c])
                    for c in range(bin_means.shape[1])
                ],
                axis=1,
            )
            return pix_ids, psums / pcounts[:, None]
        if self.channels == 3:
            sums, counts = color_sums_device(
                pix.astype(np.int64), np.round(vals).astype(np.uint8),
                image_size, self.device,
            )
            occ = np.nonzero(counts)[0]
            return occ, sums[occ].astype(np.float64) / counts[occ, None]
        counts, s1, _ = moment_sums_device(
            pix.astype(np.int64), vals[:, 0], image_size, self.device
        )
        occ = np.nonzero(counts)[0]
        return occ, (s1[occ] / counts[occ])[:, None]


class PointColorStrategy(_MeanOverBinsStrategy):
    """Binned mean of point colors (reference: generation.rs:294-363).

    Accumulates RAW u8 color values (sums of small ints are exact in f64
    AND in the device's u32 scatter-add, so host and device renders are
    bit-equal; the /255 scaling of the reference cancels against its *255
    render and only reorders floating-point rounding — within the
    reference's own HashMap-iteration nondeterminism)."""

    attributes = ("color",)

    def __init__(self, binning=None, device="cuda") -> None:
        super().__init__(binning, channels=3, device=device)
        if binning is not None:
            self.attributes = ("color", binning[0])

    def process(self, batch, bbox, image_size):
        color = batch.attributes.get("color")
        if color is None:
            raise KeyError("Coloring was requested, but point data without color found.")
        self._accumulate(batch, bbox, image_size, color.astype(np.float64))

    def render(self, image_size):
        img = np.zeros((image_size * image_size, 4), dtype=np.uint8)
        pix, means = self._pixel_means(image_size)
        if len(pix):
            img[pix, :3] = means.astype(np.uint8)
            img[pix, 3] = 255
        return img.reshape(image_size, image_size, 4)


class IntensityStrategy(_MeanOverBinsStrategy):
    """Log-brightened mean intensity (reference: generation.rs:210-290).
    Negative intensities are dropped (the reference aborts the batch; we
    filter instead)."""

    def __init__(self, min_intensity: float, max_intensity: float,
                 binning=None, device="cuda") -> None:
        super().__init__(binning, channels=1, device=device)
        self.min = min_intensity
        self.max = max_intensity
        self.attributes = ("intensity",) if binning is None else ("intensity", binning[0])

    def process(self, batch, bbox, image_size):
        intensity = batch.attributes.get("intensity")
        if intensity is None:
            raise KeyError(
                "Coloring by intensity was requested, but point data without intensity found."
            )
        keep = intensity >= 0
        if not keep.all():
            batch = batch.retain(keep)
            intensity = intensity[keep]
        self._accumulate(batch, bbox, image_size, intensity.astype(np.float64))

    def render(self, image_size):
        img = np.zeros((image_size * image_size, 4), dtype=np.uint8)
        pix, means = self._pixel_means(image_size)
        if len(pix):
            mean = np.clip(means[:, 0], self.min, self.max)
            with np.errstate(invalid="ignore", divide="ignore"):
                brighten = np.log(np.maximum(mean - self.min, 0.0)) / np.log(
                    self.max - self.min
                )
            v = np.clip(np.nan_to_num(brighten, neginf=0.0), 0.0, 1.0)
            value = (v * 255.0).astype(np.uint8)
            img[pix, 0] = value
            img[pix, 1] = value
            img[pix, 2] = value
            img[pix, 3] = 255
        return img.reshape(image_size, image_size, 4)


class HeightStddevStrategy(ColoringStrategy):
    """Per-pixel stddev of z through a colormap (generation.rs:365-405)."""

    def __init__(self, max_stddev: float, colormap: Callable = cm.monochrome,
                 device="cuda") -> None:
        self.max_stddev = max_stddev
        self.colormap = colormap
        self.device = _resolve(device)
        self._pix = []
        self._z = []

    def process(self, batch, bbox, image_size):
        pix, _, idx = discretize(batch.position, bbox, image_size)
        self._pix.append(pix)
        self._z.append(batch.position[idx, 2])

    def render(self, image_size):
        img = np.zeros((image_size * image_size, 4), dtype=np.uint8)
        if self._pix:
            pix = np.concatenate(self._pix)
            z = np.concatenate(self._z)
            if self.device is not None:
                n_all, s1_all, s2_all = moment_sums_device(
                    pix.astype(np.int64), z, image_size, self.device
                )
                uniq = np.nonzero(n_all)[0]
                n, s1, s2 = n_all[uniq], s1_all[uniq], s2_all[uniq]
            else:
                uniq, inv = np.unique(pix, return_inverse=True)
                n = np.bincount(inv)
                s1 = np.bincount(inv, weights=z)
                s2 = np.bincount(inv, weights=z * z)
            var = np.maximum(s2 / n - (s1 / n) ** 2, 0.0)
            sat = np.clip(np.sqrt(var), 0.0, self.max_stddev) / self.max_stddev
            img[uniq] = self.colormap(sat.astype(np.float32))
        return img.reshape(image_size, image_size, 4)


def make_strategy(kind: str, **kwargs) -> ColoringStrategy:
    """Factory mirroring the reference's ColoringStrategyKind
    (xray/src/generation.rs:66-96).  `device` ("cuda" by default, "cpu",
    or None for the numpy route) is where each strategy's splat reduction
    runs (device_splat.py), bit-identical to the host reductions under
    device_splat's exactness condition."""
    device = kwargs.get("device", "cuda")
    if kind == "xray":
        return XRayStrategy(device=device)
    if kind == "colored":
        return PointColorStrategy(binning=kwargs.get("binning"), device=device)
    if kind == "colored_with_intensity":
        return IntensityStrategy(
            kwargs.get("min_intensity", 1.0),
            kwargs.get("max_intensity", 1.0e5),
            binning=kwargs.get("binning"),
            device=device,
        )
    if kind == "colored_with_height_stddev":
        # Colormap selection mirrors the reference CLI's --colormap
        # (default jet; xray/src/build_quadtree.rs:67-72, 160-167).
        colormap = kwargs.get("colormap", "jet")
        if isinstance(colormap, str):
            colormap = {"jet": cm.jet, "purplish": cm.monochrome}[colormap]
        return HeightStddevStrategy(
            kwargs.get("max_stddev", 1.0), colormap=colormap, device=device
        )
    raise ValueError(f"unknown coloring strategy {kind!r}")
