"""Minimal protobuf (proto3) wire-format encoder/decoder (copy of
point_cloud_viewer_tpu/protos/pbwire.py:17-157, trimmed to what
protos/meta.py calls, and the public names of the original).

Implemented from the protobuf wire spec rather than generated code so the
framework has zero codegen steps and full control over byte-level output.
Encoders follow proto3 conventions (default-valued scalar fields are
omitted; fields are written in ascending field-number order) so output is
parseable by any conformant protobuf implementation, including the
reference's rust-protobuf readers.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LEN = 2
WIRETYPE_FIXED32 = 5

_U64_MASK = (1 << 64) - 1


def encode_varint(value: int) -> bytes:
    """Encode a non-negative integer < 2**64 as a base-128 varint."""
    if value < 0:
        raise ValueError("varints encode unsigned values; two's-complement first")
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def decode_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode a varint at `pos`; returns (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def zigzag_signed_to_u64(value: int) -> int:
    """int64 fields use plain two's-complement varints (NOT zigzag)."""
    return value & _U64_MASK


def u64_to_signed(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def u32_to_signed(value: int) -> int:
    return value - (1 << 32) if value >= (1 << 31) else value


class FieldWriter:
    """Accumulates encoded fields for one message."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def varint(self, field: int, value: int, *, signed: bool = False) -> None:
        if signed:
            value = zigzag_signed_to_u64(value)
        if value:
            self._parts.append(tag(field, WIRETYPE_VARINT) + encode_varint(value))

    def double(self, field: int, value: float) -> None:
        if value != 0.0:
            self._parts.append(tag(field, WIRETYPE_FIXED64) + struct.pack("<d", value))

    # pbwire.py:88-90, unchanged.
    def float32(self, field: int, value: float) -> None:
        if value != 0.0:
            self._parts.append(tag(field, WIRETYPE_FIXED32) + struct.pack("<f", value))

    def bytes_field(self, field: int, value: bytes) -> None:
        if value:
            self._parts.append(
                tag(field, WIRETYPE_LEN) + encode_varint(len(value)) + value
            )

    def string(self, field: int, value: str) -> None:
        self.bytes_field(field, value.encode("utf-8"))

    def message(self, field: int, encoded: bytes, *, always: bool = True) -> None:
        """Submessages are written even when empty (presence semantics)."""
        if always or encoded:
            self._parts.append(
                tag(field, WIRETYPE_LEN) + encode_varint(len(encoded)) + encoded
            )

    def finish(self) -> bytes:
        return b"".join(self._parts)


# pbwire.py:112-126, unchanged.
def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message.

    Varint fields yield ints, fixed64 yields float (double), fixed32 yields
    float, and length-delimited fields yield bytes.  Raw fixed values are
    also retrievable by re-packing; callers that need fixed64-as-int should
    use `iter_fields_raw`.
    """
    for field, wire_type, raw in iter_fields_raw(buf):
        if wire_type == WIRETYPE_FIXED64:
            yield field, wire_type, struct.unpack("<d", raw)[0]
        elif wire_type == WIRETYPE_FIXED32:
            yield field, wire_type, struct.unpack("<f", raw)[0]
        else:
            yield field, wire_type, raw


def iter_fields_raw(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a serialized message:
    fixed-width values as raw bytes, varints as ints, length-delimited
    fields as bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = decode_varint(buf, pos)
        field = key >> 3
        wire_type = key & 7
        if wire_type == WIRETYPE_VARINT:
            value, pos = decode_varint(buf, pos)
            yield field, wire_type, value
        elif wire_type == WIRETYPE_FIXED64:
            yield field, wire_type, buf[pos : pos + 8]
            pos += 8
        elif wire_type == WIRETYPE_FIXED32:
            yield field, wire_type, buf[pos : pos + 4]
            pos += 4
        elif wire_type == WIRETYPE_LEN:
            length, pos = decode_varint(buf, pos)
            yield field, wire_type, buf[pos : pos + length]
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire_type} (field {field})")


# pbwire.py:155-157, unchanged.
def parse_scalar_fields(buf: bytes) -> Dict[int, object]:
    """Parse a message into {field_number: last_value} (proto3 last-wins)."""
    return {field: value for field, _, value in iter_fields(buf)}
