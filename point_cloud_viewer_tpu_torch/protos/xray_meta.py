"""X-ray quadtree meta.pb schema (wire contract:
xray_proto_rust/src/proto.proto:17-54), with the v2 -> v3 migration on read
(v2 stored the bounding rect as Vector2f + float edge in fields 1/2).

Copy of point_cloud_viewer_tpu/protos/xray_meta.py:1-119, unchanged.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

from . import pbwire as pb

CURRENT_XRAY_VERSION = 3


def _encode_vector2d(x: float, y: float) -> bytes:
    w = pb.FieldWriter()
    w.double(1, x)
    w.double(2, y)
    return w.finish()


def _decode_vector2(buf: bytes) -> Tuple[float, float]:
    v = [0.0, 0.0]
    for f, wt, raw in pb.iter_fields_raw(buf):
        if f in (1, 2):
            if wt == pb.WIRETYPE_FIXED64:
                v[f - 1] = struct.unpack("<d", raw)[0]
            elif wt == pb.WIRETYPE_FIXED32:
                v[f - 1] = struct.unpack("<f", raw)[0]
    return v[0], v[1]


@dataclass
class RectProto:
    min: Tuple[float, float] = (0.0, 0.0)
    edge_length: float = 0.0

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.message(3, _encode_vector2d(*self.min))
        w.double(4, self.edge_length)
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "RectProto":
        mn = (0.0, 0.0)
        dep_mn = None
        edge = 0.0
        dep_edge = None
        for f, wt, raw in pb.iter_fields_raw(buf):
            if f == 3:
                mn = _decode_vector2(raw)
            elif f == 4:
                edge = struct.unpack("<d", raw)[0]
            elif f == 1:
                dep_mn = _decode_vector2(raw)
            elif f == 2:
                dep_edge = struct.unpack("<f", raw)[0]
        if edge == 0.0 and dep_edge is not None:
            edge = dep_edge
            if dep_mn is not None:
                mn = dep_mn
        return cls(min=mn, edge_length=edge)


@dataclass
class XrayNodeIdProto:
    level: int
    index: int

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.varint(1, self.level)
        w.varint(2, self.index)
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "XrayNodeIdProto":
        fields = {f: v for f, _, v in pb.iter_fields_raw(buf)}
        return cls(level=fields.get(1, 0), index=fields.get(2, 0))


@dataclass
class XrayMetaProto:
    version: int = CURRENT_XRAY_VERSION
    bounding_rect: RectProto = field(default_factory=RectProto)
    deepest_level: int = 0
    tile_size: int = 0
    nodes: List[XrayNodeIdProto] = field(default_factory=list)

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.varint(1, self.version, signed=True)
        w.message(2, self.bounding_rect.encode())
        w.varint(3, self.deepest_level)
        w.varint(4, self.tile_size)
        for n in self.nodes:
            w.message(5, n.encode())
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "XrayMetaProto":
        out = cls()
        out.nodes = []
        for f, wt, raw in pb.iter_fields_raw(buf):
            if f == 1:
                out.version = pb.u64_to_signed(raw)
            elif f == 2:
                out.bounding_rect = RectProto.decode(raw)
            elif f == 3:
                out.deepest_level = raw
            elif f == 4:
                out.tile_size = raw
            elif f == 5:
                out.nodes.append(XrayNodeIdProto.decode(raw))
        if out.version not in (2, CURRENT_XRAY_VERSION):
            raise ValueError(f"unsupported xray meta version {out.version}")
        return out
