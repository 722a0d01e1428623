"""WebMercatorRect point containment on the card (port of
point_cloud_viewer_tpu/math/web_mercator_device.py:44-127 to PyTorch).

The host test (math/web_mercator.py::WebMercatorRect.contains, mirroring
reference src/geometry/web_mercator_rect.rs:119-125) runs ECEF -> geodetic
(Bowring) -> normalized Web Mercator through the host's libm, whose
rounding the card's f64 `atan2`, `sin`, `cos`, `log` and `hypot` do not
reproduce bit for bit.  So the mask is computed by a hybrid exact scheme:

1. the card runs the SAME f64 algorithm (the same operation order: three
   Bowring iterations, the reference's latitude clamp, the same y formula)
   and classifies every point against the rect with a margin `delta`:
       definitely inside   (>= nw + delta and < se - delta on both axes)
       definitely outside  (< nw - delta or >= se + delta on either axis)
       uncertain           (within delta of a boundary);
2. the host recomputes ONLY the uncertain points with its own contains()
   (elementwise, so a row's answer does not depend on the rows beside it).

The mask equals the host mask bit for bit provided the card's projection
error stays below `delta`.  `delta` is measured, not guessed: a probe
projects a fixed grid of ECEF points on the host and on the device that
computes, and sets `delta = max(1e-9, 1000 x the largest error)`.  1e-9
normalized units is ~4 cm on the equator.  The probe runs once per device
(the JAX version caches one value per process).

On a card, query/device_filter.py classifies with K8 (csrc/query_mask.cu),
whose projection is its own f64 code: `_calibrated_delta(device,
fused=True)` measures that projection (`project_k8`), not the eager chain
below, which keeps its own margin.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from . import wgs84
from .web_mercator import LAT_BOUND_RAD, ecef_to_web_mercator


def _wmc_project(p: torch.Tensor) -> torch.Tensor:
    """torch mirror of wgs84.ecef_to_geodetic (lat/lon only) followed by
    web_mercator.lat_lng_to_web_mercator, in the same operation order."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    lon = torch.atan2(y, x)
    pr = torch.hypot(x, y)
    theta = torch.atan2(z * wgs84.SEMI_MAJOR_M, pr * wgs84.SEMI_MINOR_M)
    for _ in range(3):
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        lat = torch.atan2(
            z + wgs84.ECC2_SQ * wgs84.SEMI_MINOR_M * sin_t**3,
            pr - wgs84.ECC_SQ * wgs84.SEMI_MAJOR_M * cos_t**3,
        )
        theta = torch.atan2(wgs84.SEMI_MINOR_M * torch.sin(lat),
                            wgs84.SEMI_MAJOR_M * torch.cos(lat))
    lat = torch.clamp(lat, -LAT_BOUND_RAD, LAT_BOUND_RAD)
    sin_y = torch.sin(lat)
    mx = 0.5 + lon / (2.0 * math.pi)
    my = 0.5 - torch.log((1.0 + sin_y) / (1.0 - sin_y)) * (0.25 / math.pi)
    return torch.stack([mx, my], dim=-1)


def _classify(p: torch.Tensor, nw: torch.Tensor, se: torch.Tensor,
              delta: float) -> tuple:
    """-> (definite_in, uncertain) bool masks (N,) on p's device."""
    wmc = _wmc_project(p)
    definite_in = ((wmc >= nw + delta) & (wmc < se - delta)).all(dim=-1)
    definite_out = ((wmc < nw - delta) | (wmc >= se + delta)).any(dim=-1)
    return definite_in, ~(definite_in | definite_out)


def wmc_consts() -> np.ndarray:
    """K8's projection constants (csrc/query_mask.cu WmcConsts), 8 f64:
    the products _wmc_project forms from wgs84's constants."""
    return np.array([
        wgs84.SEMI_MAJOR_M, wgs84.SEMI_MINOR_M,
        wgs84.ECC2_SQ * wgs84.SEMI_MINOR_M, wgs84.ECC_SQ * wgs84.SEMI_MAJOR_M,
        LAT_BOUND_RAD, 2.0 * math.pi, 0.25 / math.pi, 0.0])


def project_k8(p: torch.Tensor) -> torch.Tensor:
    """(N, 3) f64 points on a card -> (N, 2) normalized Web Mercator by
    K8's own projection (pcv_web_mercator_project)."""
    from ..ops import _ext

    p = p.contiguous()
    out = torch.empty((p.shape[0], 2), dtype=torch.float64, device=p.device)
    consts = wmc_consts()
    with _ext.device_guard(p):
        _ext.check(_ext.lib().pcv_web_mercator_project(
            consts.ctypes.data, p.data_ptr(), p.shape[0], out.data_ptr(),
            _ext.stream_ptr(p)), "pcv_web_mercator_project")
    return out


@functools.lru_cache(maxsize=None)
def _calibrated_delta(device: torch.device, fused: bool = False) -> float:
    """The margin for `device`: its projection error on a fixed global grid
    against the host's, times 1000, at least 1e-9; `fused` measures K8's
    projection (a card only) instead of the eager chain.  Raises if the
    device gives a non-finite projection."""
    lat = np.linspace(-1.48, 1.48, 41)
    lon = np.linspace(-np.pi, np.pi, 41, endpoint=False)
    lat_g, lon_g = np.meshgrid(lat, lon)
    alt = np.linspace(-500.0, 10000.0, lat_g.size).reshape(lat_g.shape)
    probe = wgs84.geodetic_to_ecef(lat_g, lon_g, alt).reshape(-1, 3)
    host = ecef_to_web_mercator(probe)
    project = project_k8 if fused else _wmc_project
    dev = project(torch.from_numpy(probe).to(device)).cpu().numpy()
    err = float(np.max(np.abs(dev - host)))
    if not np.isfinite(err):
        raise RuntimeError(
            f"WebMercator probe on {device} produced non-finite values")
    return max(1e-9, err * 1000.0)


def classify_rect(rect, p: torch.Tensor) -> tuple:
    """(definite_in, uncertain) of rect on the (N, 3) f64 points p, with the
    margin calibrated on p's device."""
    corners = np.stack([rect.north_west.normalized.reshape(2),
                        rect.south_east.normalized.reshape(2)])
    nw, se = torch.tensor(corners, dtype=torch.float64, device=p.device)
    return _classify(p, nw, se, _calibrated_delta(p.device))


def rect_contains_device(rect, positions: np.ndarray,
                         device="cuda") -> np.ndarray:
    """(N, 3) f64 ECEF -> (N,) bool, bit-equal to rect.contains(positions):
    the device classifies with the calibrated margin and the host refines
    the uncertain band."""
    pos2d = np.atleast_2d(np.asarray(positions, dtype=np.float64))
    p = torch.tensor(pos2d, device=resolve_device(device))
    definite_in, uncertain = classify_rect(rect, p)
    both = torch.stack([definite_in, uncertain]).cpu().numpy()
    keep = both[0].copy()
    idx = np.flatnonzero(both[1])
    if len(idx):
        keep[idx] = rect.contains(pos2d[idx])
    return keep
