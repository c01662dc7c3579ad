"""Copy of `jaeger_tpu/train/tfrecord.py`: minimal TFRecord reading and
writing, without TensorFlow.

Implements the TFRecord wire format (length-prefixed protobuf Example
records with masked-CRC32C framing; CRCs are validated when present) and a
tiny tf.train.Example parser covering the three feature kinds
(bytes/float/int64 lists). Its varint and field readers also serve
:mod:`jaeger_tpu_torch.models.tf_checkpoint`.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator

import numpy as np

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def iter_tfrecords(path: str | Path, validate: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if validate and _masked_crc(header[:8]) != len_crc:
                raise ValueError("corrupt TFRecord length CRC")
            data = fh.read(length)
            footer = fh.read(4)
            if validate:
                (data_crc,) = struct.unpack("<I", footer)
                if _masked_crc(data) != data_crc:
                    raise ValueError("corrupt TFRecord data CRC")
            yield data


def write_tfrecord(path: str | Path, payloads: list[bytes]) -> None:
    with open(path, "wb") as fh:
        for data in payloads:
            header = struct.pack("<Q", len(data))
            fh.write(header)
            fh.write(struct.pack("<I", _masked_crc(header)))
            fh.write(data)
            fh.write(struct.pack("<I", _masked_crc(data)))


# --- tiny tf.train.Example wire parser -------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + n]
            pos += n
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == 5:
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(payload: bytes) -> dict[str, np.ndarray]:
    """Parse a tf.train.Example into {name: array} (bytes/float/int64)."""
    features: dict[str, np.ndarray] = {}
    for field, _, value in _parse_fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, fmap in _parse_fields(value):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name = None
            feat = None
            for f3, _, v3 in _parse_fields(fmap):
                if f3 == 1:
                    name = v3.decode("utf-8")
                elif f3 == 2:
                    feat = v3
            if name is None or feat is None:
                continue
            for kind, _, lst in _parse_fields(feat):
                vals: list = []
                if kind == 1:  # BytesList
                    for f4, _, v4 in _parse_fields(lst):
                        if f4 == 1:
                            vals.append(v4)
                    features[name] = np.array(vals, dtype=object)
                elif kind == 2:  # FloatList (packed)
                    for f4, w4, v4 in _parse_fields(lst):
                        if f4 == 1:
                            if w4 == 2:
                                vals.extend(
                                    struct.unpack(f"<{len(v4)//4}f", v4)
                                )
                            else:
                                vals.append(
                                    struct.unpack("<f", v4)[0]
                                )
                    features[name] = np.array(vals, dtype=np.float32)
                elif kind == 3:  # Int64List (packed varints)
                    for f4, w4, v4 in _parse_fields(lst):
                        if f4 == 1:
                            if w4 == 2:
                                pos = 0
                                while pos < len(v4):
                                    v, pos = _read_varint(v4, pos)
                                    vals.append(v)
                            else:
                                vals.append(v4)
                    features[name] = np.array(vals, dtype=np.int64)
    return features


def build_example(features: dict[str, np.ndarray | list | bytes]) -> bytes:
    """Serialize a {name: values} dict as a tf.train.Example payload."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def ld(field: int, payload: bytes) -> bytes:
        return varint(field << 3 | 2) + varint(len(payload)) + payload

    feature_entries = b""
    for name, values in features.items():
        if isinstance(values, bytes):
            lst = ld(1, ld(1, values))          # BytesList
        elif isinstance(values, (list, np.ndarray)) and len(values) and \
                isinstance(np.asarray(values).flat[0], (bytes, str)):
            payload = b"".join(
                ld(1, v if isinstance(v, bytes) else str(v).encode())
                for v in values
            )
            lst = ld(1, payload)
        else:
            arr = np.asarray(values)
            if np.issubdtype(arr.dtype, np.floating):
                packed = struct.pack(f"<{arr.size}f",
                                     *arr.astype(np.float32).ravel())
                lst = ld(2, ld(1, packed))      # FloatList packed
            else:
                packed = b"".join(varint(int(v)) for v in arr.ravel())
                lst = ld(3, ld(1, packed))      # Int64List packed
        entry = ld(1, name.encode()) + ld(2, lst)
        feature_entries += ld(1, entry)
    return ld(1, feature_entries)               # Example.features
