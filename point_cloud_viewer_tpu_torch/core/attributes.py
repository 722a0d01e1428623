"""Point attribute data model (copy of point_cloud_viewer_tpu/core/
attributes.py:19-108, trimmed to what the port reads and writes, and the
public names of the original).

Attributes are stored structure-of-arrays: each attribute is one contiguous
numpy array of shape (N,) or (N, 3).  The supported data types and their
proto enum values match the reference's `AttributeDataType`
(reference: src/attributes.rs:8-21 and
point_viewer_proto_rust/src/proto.proto:96-114), which is the on-disk and
meta.pb contract.
"""

from __future__ import annotations

import enum
from typing import Dict, Tuple

import numpy as np


class AttributeDataType(enum.IntEnum):
    """Proto enum values are the wire contract — do not renumber."""

    INVALID = 0
    U8 = 1
    U16 = 2
    U32 = 3
    U64 = 4
    I8 = 6
    I16 = 7
    I32 = 8
    I64 = 9
    F32 = 11
    F64 = 12
    U8VEC3 = 27
    F64VEC3 = 38

    @property
    def numpy_dtype(self) -> np.dtype:
        return np.dtype(_SCALAR_DTYPE[self])

    @property
    def dim(self) -> int:
        """Number of scalar components per point (1 or 3)."""
        return 3 if self in (AttributeDataType.U8VEC3, AttributeDataType.F64VEC3) else 1

    # attributes.py:45-48, unchanged.
    @property
    def size_bytes(self) -> int:
        """Bytes per point on disk (reference: src/attributes.rs:64-73)."""
        return self.numpy_dtype.itemsize * self.dim

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "AttributeDataType":
        """Infer the data type of an attribute array ((N,) or (N,3))."""
        vec = arr.ndim == 2 and arr.shape[1] == 3
        key = (np.dtype(arr.dtype).str.lstrip("<>=|"), vec)
        try:
            return _FROM_NP[key]
        except KeyError:
            raise ValueError(f"Unsupported attribute array: dtype={arr.dtype} shape={arr.shape}")


# Scalar element dtype for each attribute type (little-endian on disk).
_SCALAR_DTYPE: Dict[AttributeDataType, str] = {
    AttributeDataType.U8: "u1",
    AttributeDataType.U16: "u2",
    AttributeDataType.U32: "u4",
    AttributeDataType.U64: "u8",
    AttributeDataType.I8: "i1",
    AttributeDataType.I16: "i2",
    AttributeDataType.I32: "i4",
    AttributeDataType.I64: "i8",
    AttributeDataType.F32: "f4",
    AttributeDataType.F64: "f8",
    AttributeDataType.U8VEC3: "u1",
    AttributeDataType.F64VEC3: "f8",
}

_FROM_NP: Dict[Tuple[str, bool], AttributeDataType] = {
    ("u1", False): AttributeDataType.U8,
    ("u2", False): AttributeDataType.U16,
    ("u4", False): AttributeDataType.U32,
    ("u8", False): AttributeDataType.U64,
    ("i1", False): AttributeDataType.I8,
    ("i2", False): AttributeDataType.I16,
    ("i4", False): AttributeDataType.I32,
    ("i8", False): AttributeDataType.I64,
    ("f4", False): AttributeDataType.F32,
    ("f8", False): AttributeDataType.F64,
    ("u1", True): AttributeDataType.U8VEC3,
    ("f8", True): AttributeDataType.F64VEC3,
}


def attribute_extension(attribute: str) -> str:
    """File extension used for an attribute's per-node file
    (reference: src/lib.rs:74-80)."""
    if attribute == "position":
        return "xyz"
    if attribute == "color":
        return "rgb"
    return attribute


# The octree container has color + intensity hardcoded, because octree meta.pb
# does not serialize attribute schemas (reference: src/octree/mod.rs:52-72).
OCTREE_STANDARD_ATTRIBUTES: Dict[str, AttributeDataType] = {
    "color": AttributeDataType.U8VEC3,
    "intensity": AttributeDataType.F32,
}
