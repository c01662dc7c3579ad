"""Copy of `jaeger_tpu/models/tf_checkpoint.py`: TensorFlow checkpoint
reading without TensorFlow.

Enables weight conversion from the reference's SavedModel bundles: parses
the TensorBundle ``variables.index`` (a LevelDB-format SSTable whose
values are BundleEntry protos, in plain or snappy-compressed blocks),
reads raw tensors from ``variables.data-*``, and decodes the
``_CHECKPOINTABLE_OBJECT_GRAPH`` (TrackableObjectGraph proto) so
checkpoint keys can be resolved to human-readable object paths (layer /
attribute names).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from jaeger_tpu_torch.train.tfrecord import _parse_fields, _read_varint

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset checkpoints use)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: object, 9: np.int64, 10: np.bool_, 14: np.dtype("<f2"),
    19: np.dtype("<f2"),  # bfloat16 stored as uint16; reinterpret later
    22: np.uint32, 23: np.uint64,
}


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Read a table block; trailer is [compression(1), crc(4)]."""
    block = data[offset : offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return block
    if ctype == 1:
        return _snappy_decompress(block)
    raise ValueError(f"unsupported block compression {ctype}")


def _snappy_decompress(data: bytes) -> bytes:
    """Minimal snappy decoder (LevelDB block compression)."""
    length, pos = _read_varint(data, 0)
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            size = (tag >> 2) + 1
            if size > 60:
                extra = size - 60
                size = int.from_bytes(data[pos : pos + extra], "little") + 1
                pos += extra
            out += data[pos : pos + size]
            pos += size
        else:
            if kind == 1:
                size = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                size = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 2], "little")
                pos += 2
            else:
                size = (tag >> 2) + 1
                off = int.from_bytes(data[pos : pos + 4], "little")
                pos += 4
            for _ in range(size):
                out.append(out[-off])
    return bytes(out[:length])


def _iter_block_entries(block: bytes):
    """Yield (key, value) pairs from a LevelDB block."""
    n_restarts = struct.unpack("<I", block[-4:])[0]
    data_end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + value_len]
        pos += value_len
        yield key, value


def _decode_handle(value: bytes) -> tuple[int, int]:
    offset, pos = _read_varint(value, 0)
    size, _ = _read_varint(value, pos)
    return offset, size


def _decode_bundle_entry(value: bytes) -> dict:
    """BundleEntryProto: dtype(1) shape(2) shard_id(3) offset(4) size(5)."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0}
    for field, wire, v in _parse_fields(value):
        if field == 1:
            entry["dtype"] = v
        elif field == 2:
            dims = []
            for f2, _, v2 in _parse_fields(v):
                if f2 == 2:  # TensorShapeProto.dim
                    for f3, _, v3 in _parse_fields(v2):
                        if f3 == 1:
                            # zigzag? dim.size is int64 plain varint
                            dims.append(
                                v3 if v3 < (1 << 62) else v3 - (1 << 64)
                            )
            entry["shape"] = dims
        elif field == 3:
            entry["shard_id"] = v
        elif field == 4:
            entry["offset"] = v
        elif field == 5:
            entry["size"] = v
    return entry


def read_index(index_path: str | Path) -> dict[str, dict]:
    """Parse variables.index -> {tensor_name: bundle entry dict}."""
    data = Path(index_path).read_bytes()
    magic = struct.unpack("<Q", data[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError("not a TensorBundle/LevelDB table file")
    footer = data[-48:]
    pos = 0
    _, pos = _read_varint(footer, pos)          # metaindex offset
    _, pos = _read_varint(footer, pos)          # metaindex size
    idx_off, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)
    index_block = _read_block(data, idx_off, idx_size)

    entries: dict[str, dict] = {}
    for _, handle in _iter_block_entries(index_block):
        b_off, b_size = _decode_handle(handle)
        for key, value in _iter_block_entries(_read_block(data, b_off, b_size)):
            name = key.decode("utf-8", "replace")
            if name == "":
                continue  # bundle header
            entries[name] = _decode_bundle_entry(value)
    return entries


def read_tensor(data_dir: str | Path, entry: dict) -> np.ndarray:
    shard = Path(data_dir) / (
        f"variables.data-{entry['shard_id']:05d}-of-00001"
    )
    if not shard.exists():
        candidates = sorted(Path(data_dir).glob("variables.data-*"))
        shard = candidates[entry["shard_id"]]
    raw = shard.read_bytes()[entry["offset"] : entry["offset"] + entry["size"]]
    dtype = _DTYPES.get(entry["dtype"])
    if dtype is object:
        raise ValueError("string tensors not supported")
    arr = np.frombuffer(raw, dtype=dtype)
    if entry["dtype"] == 19:  # bfloat16: upcast via int16 << 16
        arr = (
            arr.view(np.uint16).astype(np.uint32) << 16
        ).view(np.float32)
    return arr.reshape(entry["shape"])


def decode_object_graph(payload: bytes) -> list[dict]:
    """TrackableObjectGraph -> list of nodes with children/attributes."""
    nodes = []
    for field, _, node_bytes in _parse_fields(payload):
        if field != 1:
            continue
        node = {"children": [], "attributes": []}
        for f2, _, v2 in _parse_fields(node_bytes):
            if f2 == 1:  # children: ObjectReference {node_id(1), local_name(2)}
                child = {"node_id": 0, "local_name": ""}
                for f3, _, v3 in _parse_fields(v2):
                    if f3 == 1:
                        child["node_id"] = v3
                    elif f3 == 2:
                        child["local_name"] = v3.decode("utf-8", "replace")
                node["children"].append(child)
            elif f2 == 2:  # attributes: {name(1), full_name(2), checkpoint_key(3)}
                attr = {"name": "", "full_name": "", "checkpoint_key": ""}
                for f3, _, v3 in _parse_fields(v2):
                    if f3 == 1:
                        attr["name"] = v3.decode("utf-8", "replace")
                    elif f3 == 2:
                        attr["full_name"] = v3.decode("utf-8", "replace")
                    elif f3 == 3:
                        attr["checkpoint_key"] = v3.decode("utf-8", "replace")
                node["attributes"].append(attr)
        nodes.append(node)
    return nodes


def checkpoint_key_paths(nodes: list[dict]) -> dict[str, str]:
    """checkpoint_key -> slash-joined object path with local names."""
    paths: dict[str, str] = {}
    seen: set[int] = set()

    def walk(node_id: int, path: str):
        if node_id in seen or node_id >= len(nodes):
            return
        seen.add(node_id)
        node = nodes[node_id]
        for attr in node["attributes"]:
            if attr["checkpoint_key"]:
                label = attr["full_name"] or attr["name"]
                paths.setdefault(attr["checkpoint_key"],
                                 f"{path}/{label}".lstrip("/"))
        for child in node["children"]:
            walk(child["node_id"], f"{path}/{child['local_name']}")

    walk(0, "")
    return paths


def load_checkpoint(saved_model_dir: str | Path) -> dict[str, np.ndarray]:
    """Load all tensors from a SavedModel's variables/ directory.

    Returns {object_path_or_key: array}; object paths come from the
    checkpointable object graph when present (full variable names like
    ``.../dense/kernel``), else the raw checkpoint keys.
    """
    var_dir = Path(saved_model_dir) / "variables"
    if not var_dir.exists():
        var_dir = Path(saved_model_dir)
    entries = read_index(var_dir / "variables.index")

    names: dict[str, str] = {}
    og = entries.get("_CHECKPOINTABLE_OBJECT_GRAPH")
    if og is not None:
        raw = read_tensor(var_dir, og) if og["dtype"] != 7 else None
        if raw is None:
            # string tensor: payload is [varint length][bytes]
            shard = var_dir / f"variables.data-{og['shard_id']:05d}-of-00001"
            blob = shard.read_bytes()[
                og["offset"] : og["offset"] + og["size"]
            ]
            # string-tensor framing: [varint length][crc32c][payload]
            length, pos = _read_varint(blob, 0)
            payload = blob[pos + 4 : pos + 4 + length]
            names = checkpoint_key_paths(decode_object_graph(payload))

    out: dict[str, np.ndarray] = {}
    for key, entry in entries.items():
        if key == "_CHECKPOINTABLE_OBJECT_GRAPH" or entry["dtype"] == 7:
            continue
        label = names.get(key, key)
        out[label] = read_tensor(var_dir, entry)
    return out
