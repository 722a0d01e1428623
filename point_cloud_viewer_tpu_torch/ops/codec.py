"""Position codecs: fixpoint / normalized-float encodings, vectorized (copy
of point_cloud_viewer_tpu/ops/codec.py:23-138).

Every octree node stores positions scaled to its bounding cube
('ScaledToCube'): t = clamp((p - cube_min) / edge, 0, 1), stored either as
fixpoint integers (t * T_MAX, truncated — matching Rust `as` casts) or as
normalized f32/f64.  The encoding width is picked from the node's edge
length and the cloud resolution.  (Reference semantics:
src/read_write/codec.rs:30-139.)
"""

from __future__ import annotations

import enum

import numpy as np

from ..protos.meta import PositionEncodingProto


class PositionEncoding(enum.IntEnum):
    """Storage width of node positions. Values match PositionEncodingProto."""

    UINT8 = 1
    UINT16 = 2
    FLOAT32 = 3
    FLOAT64 = 4

    @property
    def bytes_per_coordinate(self) -> int:
        return {1: 1, 2: 2, 3: 4, 4: 8}[int(self)]

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype({1: "<u1", 2: "<u2", 3: "<f4", 4: "<f8"}[int(self)])

    def to_proto(self) -> PositionEncodingProto:
        return PositionEncodingProto(int(self))

    @classmethod
    def from_proto(cls, proto: PositionEncodingProto) -> "PositionEncoding":
        if proto == PositionEncodingProto.INVALID:
            raise ValueError("PositionEncoding is invalid")
        return cls(int(proto))


def position_encoding_for(edge_length: float, resolution: float) -> PositionEncoding:
    """Pick the narrowest encoding resolving `resolution` within a node of
    `edge_length`.  min_bits = trunc(log2(edge/res)) + 1; <=8 -> u8,
    <=16 -> u16, <=24 -> f32 (~1 mm at 8389 km), else f64
    (reference: src/read_write/codec.rs:30-40)."""
    ratio = edge_length / resolution
    if ratio <= 0 or not np.isfinite(ratio):
        return PositionEncoding.UINT8
    min_bits = max(int(np.log2(ratio)), 0) + 1  # int() truncates like `as u32`
    if min_bits <= 8:
        return PositionEncoding.UINT8
    if min_bits <= 16:
        return PositionEncoding.UINT16
    if min_bits <= 24:
        return PositionEncoding.FLOAT32
    return PositionEncoding.FLOAT64


def encode_positions(
    positions: np.ndarray,
    cube_min: np.ndarray,
    edge_length,
    encoding: PositionEncoding,
) -> np.ndarray:
    """Encode (N, 3) f64 world positions into the node-local representation.

    `cube_min` may be (3,) or per-point (N, 3); `edge_length` a scalar or
    (N,) — the builder passes per-point node geometry so one call covers an
    entire level.  Integer conversion truncates toward zero, matching the
    reference's `nalgebra::try_convert` (Rust `as` semantics).
    """
    positions = np.asarray(positions, dtype=np.float64)
    edge = np.asarray(edge_length, dtype=np.float64)
    if edge.ndim == 1:
        edge = edge[:, None]
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (positions - cube_min) / edge
    # Degenerate (zero-edge) cubes produce NaN; store as 0 (decodes to min,
    # matching the reference's NaN-as-cast behavior).
    t = np.clip(np.nan_to_num(t, nan=0.0), 0.0, 1.0)
    if encoding == PositionEncoding.UINT8:
        return (t * 255.0).astype("<u1")
    if encoding == PositionEncoding.UINT16:
        return (t * 65535.0).astype("<u2")
    if encoding == PositionEncoding.FLOAT32:
        return t.astype("<f4")
    return t.astype("<f8")


def decode_positions(
    encoded: np.ndarray,
    cube_min: np.ndarray,
    edge_length,
    encoding: PositionEncoding,
) -> np.ndarray:
    """Inverse of encode_positions -> (N, 3) f64 world positions."""
    if (
        len(encoded) >= 10_000
        and encoding in (PositionEncoding.UINT8, PositionEncoding.UINT16)
    ):
        # Query hot path: one fused native pass.  Results may differ from
        # the numpy expression below by 1 ulp (the compiler contracts the
        # multiply-add into an FMA) — far below the codec's guaranteed
        # `resolution` tolerance.
        from .. import native

        out = native.decode_positions(
            np.ascontiguousarray(encoded), cube_min, edge_length
        )
        if out is not None:
            return out
    edge = np.asarray(edge_length, dtype=np.float64)
    if edge.ndim == 1:
        edge = edge[:, None]
    if encoding == PositionEncoding.UINT8:
        t = encoded.astype(np.float64) / 255.0
    elif encoding == PositionEncoding.UINT16:
        t = encoded.astype(np.float64) / 65535.0
    else:
        t = encoded.astype(np.float64)
    return t * edge + cube_min


# codec.py:132-138, unchanged.
def encode_plain(positions: np.ndarray) -> np.ndarray:
    """'Plain' encoding: raw little-endian f64 world coordinates."""
    return np.asarray(positions, dtype="<f8")


def decode_plain(encoded: np.ndarray) -> np.ndarray:
    return encoded.astype(np.float64)
