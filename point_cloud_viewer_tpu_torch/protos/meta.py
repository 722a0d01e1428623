"""point_viewer meta.pb schema — encoder/decoder (copy of
point_cloud_viewer_tpu/protos/meta.py:22-308).

Message and field-number layout follows the reference's wire contract
(point_viewer_proto_rust/src/proto.proto:17-149) so metas written here are
readable by the reference tools and vice versa.  Reading performs the version
9→13 migrations in one place (reference: src/octree/mod.rs:154-215 and
src/octree/node.rs:88-106), always yielding a canonical v13-shaped object.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.attributes import AttributeDataType
from ..core.constants import CURRENT_VERSION
from . import pbwire as pb


class PositionEncodingProto(enum.IntEnum):
    INVALID = 0
    UINT8 = 1
    UINT16 = 2
    FLOAT32 = 3
    FLOAT64 = 4


# ---------------------------------------------------------------------------
# Vectors


def _encode_vector3d(xyz: Tuple[float, float, float]) -> bytes:
    w = pb.FieldWriter()
    w.double(1, xyz[0])
    w.double(2, xyz[1])
    w.double(3, xyz[2])
    return w.finish()


def _decode_vector3(buf: bytes) -> Tuple[float, float, float]:
    """Decodes either Vector3d (doubles) or Vector3f (floats)."""
    v = [0.0, 0.0, 0.0]
    for f, wt, raw in pb.iter_fields_raw(buf):
        if 1 <= f <= 3:
            if wt == pb.WIRETYPE_FIXED64:
                v[f - 1] = struct.unpack("<d", raw)[0]
            elif wt == pb.WIRETYPE_FIXED32:
                v[f - 1] = struct.unpack("<f", raw)[0]
    return (v[0], v[1], v[2])


# ---------------------------------------------------------------------------
# Bounding box (AxisAlignedCuboid)


@dataclass
class BoundingBoxProto:
    """AxisAlignedCuboid: fields 3/4 are the live Vector3d min/max; fields
    1/2 carry the deprecated Vector3f pair for version <= 10 inputs."""

    min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    max: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.message(3, _encode_vector3d(self.min))
        w.message(4, _encode_vector3d(self.max))
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "BoundingBoxProto":
        mins: Dict[int, Tuple[float, float, float]] = {}
        maxs: Dict[int, Tuple[float, float, float]] = {}
        for f, _, raw in pb.iter_fields_raw(buf):
            if f in (1, 3):
                mins[f] = _decode_vector3(raw)
            elif f in (2, 4):
                maxs[f] = _decode_vector3(raw)
        # Prefer the live double fields; fall back to the deprecated floats.
        return cls(min=mins.get(3, mins.get(1, (0.0,) * 3)),
                   max=maxs.get(4, maxs.get(2, (0.0,) * 3)))


# ---------------------------------------------------------------------------
# NodeId + OctreeNode


def encode_node_id(node_id_value: int) -> bytes:
    """NodeId message from the packed u128 value (level<<120 | path)."""
    w = pb.FieldWriter()
    w.varint(3, (node_id_value >> 64) & ((1 << 64) - 1))
    w.varint(4, node_id_value & ((1 << 64) - 1))
    return w.finish()


def decode_node_id(buf: bytes) -> int:
    """Returns the packed u128 NodeId value, migrating the version<=9
    (level, index) representation when present."""
    high = low = 0
    dep_level = dep_index = 0
    for f, _, value in pb.iter_fields_raw(buf):
        if f == 3:
            high = value
        elif f == 4:
            low = value
        elif f == 1:
            dep_level = pb.u32_to_signed(value & ((1 << 32) - 1)) if value else 0
        elif f == 2:
            dep_index = pb.u64_to_signed(value)
    if dep_level != 0 or dep_index != 0:
        return ((dep_level & 0xFF) << 120) | (dep_index & ((1 << 120) - 1))
    return (high << 64) | low


@dataclass
class OctreeNodeProto:
    id: int  # packed u128
    num_points: int
    position_encoding: PositionEncodingProto

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.varint(2, int(self.position_encoding))
        w.varint(3, self.num_points, signed=True)
        w.message(4, encode_node_id(self.id))
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "OctreeNodeProto":
        node_id = 0
        num_points = 0
        enc = PositionEncodingProto.INVALID
        for f, _, value in pb.iter_fields_raw(buf):
            if f == 2:
                enc = PositionEncodingProto(value)
            elif f == 3:
                num_points = pb.u64_to_signed(value)
            elif f == 4:
                node_id = decode_node_id(value)
        return cls(id=node_id, num_points=num_points, position_encoding=enc)


# ---------------------------------------------------------------------------
# S2 messages


@dataclass
class S2CellProto:
    id: int  # u64 S2 cell id
    num_points: int

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.varint(1, self.id)
        w.varint(2, self.num_points)
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "S2CellProto":
        fields = {f: v for f, _, v in pb.iter_fields_raw(buf)}
        return cls(id=fields.get(1, 0), num_points=fields.get(2, 0))


@dataclass
class AttributeProto:
    name: str
    data_type: AttributeDataType

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.string(1, self.name)
        w.varint(2, int(self.data_type))
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "AttributeProto":
        name = ""
        dt = AttributeDataType.INVALID
        for f, _, value in pb.iter_fields_raw(buf):
            if f == 1:
                name = value.decode("utf-8")
            elif f == 2:
                dt = AttributeDataType(value)
        return cls(name=name, data_type=dt)


@dataclass
class S2MetaProto:
    cells: List[S2CellProto] = field(default_factory=list)
    attributes: List[AttributeProto] = field(default_factory=list)

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        for c in self.cells:
            w.message(1, c.encode())
        for a in self.attributes:
            w.message(2, a.encode())
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "S2MetaProto":
        out = cls()
        for f, _, raw in pb.iter_fields_raw(buf):
            if f == 1:
                out.cells.append(S2CellProto.decode(raw))
            elif f == 2:
                out.attributes.append(AttributeProto.decode(raw))
        return out


# ---------------------------------------------------------------------------
# OctreeMeta + top-level Meta


@dataclass
class OctreeMetaProto:
    resolution: float = 0.0
    nodes: List[OctreeNodeProto] = field(default_factory=list)

    def encode(self) -> bytes:
        w = pb.FieldWriter()
        w.double(2, self.resolution)
        for n in self.nodes:
            w.message(3, n.encode())
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> Tuple["OctreeMetaProto", Optional[BoundingBoxProto]]:
        """Returns the octree meta plus the deprecated (v12) bounding box."""
        out = cls()
        dep_bbox: Optional[BoundingBoxProto] = None
        for f, wt, raw in pb.iter_fields_raw(buf):
            if f == 1:
                dep_bbox = BoundingBoxProto.decode(raw)
            elif f == 2:
                out.resolution = struct.unpack("<d", raw)[0]
            elif f == 3:
                out.nodes.append(OctreeNodeProto.decode(raw))
        return out, dep_bbox


@dataclass
class MetaProto:
    """Canonical (v13-shaped) representation of meta.pb.

    Exactly one of `octree` / `s2` is set (the proto oneof).
    """

    version: int = CURRENT_VERSION
    bounding_box: BoundingBoxProto = field(default_factory=BoundingBoxProto)
    octree: Optional[OctreeMetaProto] = None
    s2: Optional[S2MetaProto] = None

    def encode(self) -> bytes:
        if (self.octree is None) == (self.s2 is None):
            raise ValueError("exactly one of octree/s2 must be set")
        w = pb.FieldWriter()
        w.varint(1, self.version, signed=True)
        w.message(4, self.bounding_box.encode())
        if self.octree is not None:
            w.message(6, self.octree.encode())
        else:
            w.message(7, self.s2.encode())
        return w.finish()

    @classmethod
    def decode(cls, buf: bytes) -> "MetaProto":
        version = 0
        bbox: Optional[BoundingBoxProto] = None
        octree: Optional[OctreeMetaProto] = None
        octree_dep_bbox: Optional[BoundingBoxProto] = None
        s2: Optional[S2MetaProto] = None
        dep_resolution = 0.0
        dep_nodes: List[OctreeNodeProto] = []
        for f, wt, raw in pb.iter_fields_raw(buf):
            if f == 1:
                version = pb.u64_to_signed(raw)
            elif f == 3:
                dep_resolution = struct.unpack("<d", raw)[0]
            elif f == 4:
                bbox = BoundingBoxProto.decode(raw)
            elif f == 5:
                dep_nodes.append(OctreeNodeProto.decode(raw))
            elif f == 6:
                octree, octree_dep_bbox = OctreeMetaProto.decode(raw)
            elif f == 7:
                s2 = S2MetaProto.decode(raw)

        if version in (9, 10, 11):
            # Migrate: resolution/nodes lived at the top level.
            octree = OctreeMetaProto(resolution=dep_resolution, nodes=dep_nodes)
        elif version == 12:
            # Bounding box lived inside OctreeMeta.
            if octree_dep_bbox is not None:
                bbox = octree_dep_bbox
        elif version != CURRENT_VERSION:
            raise ValueError(f"unsupported meta version {version}")

        if octree is None and s2 is None:
            raise ValueError("meta contains neither octree nor s2 data")
        return cls(
            version=version,
            bounding_box=bbox or BoundingBoxProto(),
            octree=octree,
            s2=s2,
        )
