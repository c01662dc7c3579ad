"""Copy of `jaeger_tpu/dataops/convert.py`.

CSV -> NPZ offline dataset conversion.

Parity target: reference ``dataops/convert.py`` (``convert_dataset``,
:1557) — the ``jaeger utils optimize-data`` engine. The reference reaches
throughput with numba-JIT per-element loops; this redesign uses fully
vectorized numpy over batches (ASCII LUT gather, strided trigram views),
which needs no JIT warmup and parallelizes trivially.

Output NPZ contract (identical keys so either loader can read either
product):

* ``translated``           (N, 6, L) int32 tokens, ``codon_id + 1``,
                           0 = pad/ambiguous (or an object array of
                           per-crop trimmed arrays when ``pad=False``)
* ``translated_lengths``   (N,) per-crop frame count ``min(len, crop)//3 - 1``
* ``nucleotide``           (N, 2, L) ints per ``nucleotide_map``
                           (default {A:1,G:2,T:3,C:4,N:0}) or one-hot
* ``labels``, ``lengths``  (N,) int32
* ``codon_map``, ``nucleotide_map`` provenance strings
* streaming mode shards arrays as ``<key>_00000.npy`` entries plus a
  ``_jaeger_manifest`` record, like the reference's sharded NPZ.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

from jaeger_tpu_torch.seqops import maps
from jaeger_tpu_torch.seqops.windows import UPPER_LUT, encode_ascii

_CODON_MAP_NAMES = {
    "codon_id": "CODON_ID",
    "aa_id": "AA_ID",
    "pc5_id": "PC5_ID",
    "murphy10_id": "MURPHY10_ID",
    "cod_id": "DICODON_ID",
    "pc2_id": "PC2_ID",
    "dicodon_id": "DICODON_ID",
}

_DEFAULT_NUCLEOTIDE_MAP = {"A": 1, "G": 2, "T": 3, "C": 4, "N": 0}


def _codon_lut(codon_map: str) -> tuple[np.ndarray, int, bool]:
    """(flat 125-entry trigram LUT, n_classes, is_dicodon)."""
    attr = _CODON_MAP_NAMES.get(codon_map.lower())
    if attr is None:
        raise ValueError(f"unknown codon map: {codon_map}")
    is_dicodon = attr == "DICODON_ID"
    base_ids = maps.CODON_ID if is_dicodon else list(getattr(maps, attr))
    lut = np.full(125, -1, dtype=np.int64)
    bases = "ATGCN"
    table = {c: i for c, i in zip(maps.CODONS, base_ids)}
    for i0 in range(4):
        for i1 in range(4):
            for i2 in range(4):
                tri = bases[i0] + bases[i1] + bases[i2]
                lut[i0 * 25 + i1 * 5 + i2] = table[tri]
    n = 4096 if is_dicodon else (max(base_ids) + 1)
    return lut, n, is_dicodon


def translated_frame_length(crop_size: int, dicodon: bool = False) -> int:
    """Array-converter frame arithmetic: ``crop//3 - 1`` (``-2`` dicodon).

    Parity: reference ``dataops/convert.py:497-530`` /
    ``seqops/crop.py:64-67``.
    """
    k = crop_size // 3 - (2 if dicodon else 1)
    return max(0, k)


def valid_codon_lengths(lengths: np.ndarray, crop_size: int,
                        dicodon: bool = False) -> np.ndarray:
    """Per-crop valid codon count — the reference's converter arithmetic
    (``_single_codon_actual_lengths``, ``dataops/convert.py:497-530``):
    min over the three frames with the offset from the CROPPED length's
    own mod-3. Note this intentionally differs from the TF inference
    path, whose offset comes from the crop size — for ``m % 3 == 0``
    sub-crop rows the two disagree by one token; both reference
    behaviors are mirrored faithfully (pinned live in
    ``tests/test_convert_live_parity.py``)."""
    m = np.minimum(lengths.astype(np.int64), crop_size)
    off = np.array([-2, -1, 0], dtype=np.int64)[m % 3]
    v = np.maximum((m - 3 + off) // 3, 0)
    v = np.where(m < 3, 0, v)
    if dicodon:
        v = np.maximum(v - 1, 0)
    return v.astype(np.int32)


def encode_translated_batch(
    bases: np.ndarray, lengths: np.ndarray, crop_size: int,
    codon_map: str = "codon_id",
) -> np.ndarray:
    """(N, crop) base IDs -> (N, 6, L) int32 tokens (+1 shifted, 0 = pad).

    Vectorized equivalent of the reference's numba kernels
    (``_process_batch_numba`` / ``_process_batch_numba_dicodon``,
    ``dataops/convert.py:557-744``).
    """
    lut, n_classes, dicodon = _codon_lut(codon_map)
    n = bases.shape[0]
    C = crop_size
    k = translated_frame_length(C, dicodon)
    b = UPPER_LUT[bases[:, :C]].astype(np.int64)
    m = np.minimum(lengths.astype(np.int64), C)

    comp = np.array([1, 0, 3, 2, 4], dtype=np.int64)
    pos = np.arange(C)[None, :]
    ridx = m[:, None] - 1 - pos
    rb = np.take_along_axis(b, np.clip(ridx, 0, C - 1), axis=1)
    rb = np.where(ridx >= 0, comp[rb], 4)

    def codons(x):
        tri = x[:, :-2] * 25 + x[:, 1:-1] * 5 + x[:, 2:]
        return lut[tri]  # (N, C-2), -1 for ambiguous

    cf, cr = codons(b), codons(rb)
    if dicodon:
        # dicodon id = c1 * 64 + c2 with c2 three positions later; any
        # ambiguous half -> -1
        def dicodons(c):
            c1, c2 = c[:, :-3], c[:, 3:]
            d = c1 * 64 + c2
            return np.where((c1 < 0) | (c2 < 0), -1, d)

        cf, cr = dicodons(cf), dicodons(cr)

    def frames(c):
        return np.stack([c[:, off::3][:, :k] for off in range(3)], axis=1)

    out = np.concatenate([frames(cf), frames(cr)], axis=1)  # (N, 6, k)
    valid_k = valid_codon_lengths(m, C, dicodon)
    mask = np.arange(k)[None, None, :] < valid_k[:, None, None]
    return ((out + 1) * mask).astype(np.int32)


def encode_nucleotide_batch(
    bases: np.ndarray, lengths: np.ndarray, crop_size: int,
    nucleotide_map: dict[str, int] | None = None,
    one_hot: bool = False, pad_int: int = 0,
) -> np.ndarray:
    """(N, crop) base IDs -> (N, 2, crop) ints or (N, 2, crop, 4) one-hot.

    Vectorized equivalent of ``_encode_nucleotide_batch_int/oh``
    (reference ``dataops/convert.py:276-345``). Note the converter's
    second channel is the complement **at the same position** (no
    reversal) — unlike the reference's own TF inference pipeline, which
    reverse-complements; both behaviors are mirrored faithfully (pinned
    live in ``tests/test_convert_live_parity.py``). One-hot channels use
    the reference's fixed A,G,T,C order (``convert.py:253``), ignoring
    the user integer map.
    """
    nmap = nucleotide_map or _DEFAULT_NUCLEOTIDE_MAP
    C = crop_size
    b = UPPER_LUT[bases[:, :C]].astype(np.int64)  # A0 T1 G2 C3 N4
    m = np.minimum(lengths.astype(np.int64), C)
    pos = np.arange(C)[None, :]
    valid = pos < m[:, None]
    b = np.where(valid, b, 4)
    comp_b = np.where(b < 4, b ^ 1, 4)  # A<->T, G<->C in base-ID space

    if one_hot:
        # base-ID -> A,G,T,C channel index; N -> -1 (zero row)
        chan = np.array([0, 2, 1, 3, -1], dtype=np.int64)
        ids = np.stack([chan[b], chan[comp_b]], axis=1)  # (N, 2, C)
        oh = np.zeros(ids.shape + (4,), dtype=np.float32)
        np.put_along_axis(
            oh, np.clip(ids, 0, 3)[..., None], 1.0, axis=-1
        )
        oh[ids < 0] = 0.0
        return oh
    # integer encoding via the user map; beyond-length stays pad_int
    code = np.array(
        [nmap.get(ch, nmap.get("N", 0)) for ch in "ATGC"]
        + [nmap.get("N", 0)],
        dtype=np.int64,
    )
    out = np.stack([code[b], code[comp_b]], axis=1)
    pad_pos = ~np.stack([valid, valid], axis=1)
    out[pad_pos] = pad_int
    return out.astype(np.int32)


def _crop_starts(seq_len: int, crop_size: int, stride: int,
                 pad_to_max: bool = True) -> list[int]:
    """Sliding-crop starts (reference ``convert.py:346-369``)."""
    if stride == 0 or seq_len <= crop_size:
        return [0]
    if pad_to_max:
        starts = list(range(0, seq_len - crop_size + 1, stride))
        if starts[-1] + crop_size < seq_len:
            starts.append(seq_len - crop_size)
    else:
        starts = list(range(0, seq_len, stride))
    return starts


def _read_csv(input_path) -> tuple[list[np.ndarray], np.ndarray]:
    seqs: list[np.ndarray] = []
    labels: list[int] = []
    with open(input_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 2:
                continue
            try:
                label = int(parts[0])
            except ValueError:
                continue
            seqs.append(encode_ascii(parts[1]))
            labels.append(label)
    return seqs, np.asarray(labels, dtype=np.int32)


def _class_interleaved_permutation(labels: np.ndarray, seed: int) -> np.ndarray:
    """Shuffle within class, then deal classes with a smooth weighted
    round-robin so every shard slice is class-balanced.

    Parity: reference ``convert.py:1006-1080`` (deficit scheduler).
    """
    labels = np.asarray(labels)
    total = len(labels)
    if total == 0:
        return np.empty(0, dtype=np.int64)
    rng = np.random.default_rng(seed)
    _, inverse = np.unique(labels, return_inverse=True)
    pools = []
    for c in range(int(inverse.max()) + 1):
        idx = np.flatnonzero(inverse == c)
        rng.shuffle(idx)
        pools.append(idx)
    # integer deficits (+counts each step, -total on pick) make the
    # schedule exact and tie-breaks deterministic — seed-for-seed
    # identical to the reference (pinned live)
    counts = np.array([len(p) for p in pools], dtype=np.int64)
    deficits = np.zeros(len(pools), dtype=np.int64)
    ptr = np.zeros(len(pools), dtype=np.int64)
    out = np.empty(total, dtype=np.int64)
    for i in range(total):
        deficits += counts
        c = int(np.argmax(deficits))
        deficits[c] -= total
        out[i] = pools[c][ptr[c]]
        ptr[c] += 1
    return out


def save_npz(output_path, data: dict, compress: str = "default") -> None:
    """NPZ writer with the reference's fast/default/none compression modes
    (``convert.py:154-172``)."""
    compress = compress.lower()
    if compress == "default":
        np.savez_compressed(output_path, **data)
    elif compress == "none":
        np.savez(output_path, **data)
    elif compress == "fast":
        with zipfile.ZipFile(
            output_path, "w", compression=zipfile.ZIP_DEFLATED, compresslevel=1
        ) as zf:
            for key, arr in data.items():
                buf = io.BytesIO()
                np.save(buf, np.asarray(arr))
                zf.writestr(f"{key}.npy", buf.getvalue())
    else:
        raise ValueError(f"invalid compress mode {compress!r}")


def convert_dataset(
    input_path: str,
    output_path: str,
    format: str = "translated",
    crop_size: int | list[int] | tuple = 500,
    stride: int = 0,
    strides: list[int] | None = None,
    num_classes: int = 3,
    one_hot: bool = False,
    pad_int: int = 0,
    codon_map: str = "codon_id",
    nucleotide_map: str | dict | None = None,
    compress: str = "default",
    pad: bool = False,
    balance_classes: bool = False,
    shuffle_seed: int = 42,
    shard_size: int | None = None,
    workers: int = 0,
    num_workers: int | None = None,
    dtype: str = "auto",
    max_length: int = 5000,  # deprecated, ignored (reference parity)
    max_memory_mb: int | None = None,
) -> dict:
    """Convert a ``label,sequence`` CSV into an NPZ dataset.

    ``shard_size`` switches to the streaming sharded layout (one
    ``<key>_NNNNN.npy`` group per shard + ``_jaeger_manifest``), replacing
    the reference's RAM-budget dispatch with an explicit knob.
    ``workers > 1`` materializes shards/chunks on a thread pool (the
    numpy encode kernels release the GIL) — host-pipeline parity with
    the reference's converter multiprocessing (``convert.py:17-19``).
    Returns a summary dict (counts per class, shapes).
    """
    fmt = format.lower()
    if fmt not in ("translated", "nucleotide", "both"):
        raise ValueError(f"invalid format {format!r}")
    if num_workers is not None and not workers:
        workers = int(num_workers)  # reference spelling
    crop_sizes = (
        [int(crop_size)] if isinstance(crop_size, int) else
        [int(c) for c in crop_size]
    )
    stride_list = (
        [int(s) for s in strides] if strides is not None
        else [int(stride)] * len(crop_sizes)
    )
    if len(stride_list) != len(crop_sizes):
        raise ValueError("strides must match crop_sizes")
    nmap = nucleotide_map
    if isinstance(nmap, str):
        nmap = json.loads(nmap)
    _, _, dicodon = _codon_lut(codon_map)

    # smallest integer dtype that fits the vocabulary (reference
    # _select_dtype, convert.py:1320-1350); one-hot floats stay float32
    if one_hot:
        sel_dtype = np.dtype(np.float32)
    elif str(dtype).lower() != "auto":
        sel_dtype = np.dtype(str(dtype).lower())
    else:
        max_token = 0
        if fmt in ("translated", "both"):
            _, vocab, _ = _codon_lut(codon_map)
            max_token = vocab + 1  # +1 pad shift
        if fmt in ("nucleotide", "both"):
            nm = nmap if isinstance(nmap, dict) else _DEFAULT_NUCLEOTIDE_MAP
            max_token = max(max_token, max(nm.values()))
        if max_token < 128:
            sel_dtype = np.dtype(np.int8)
        elif max_token < 256:
            sel_dtype = np.dtype(np.uint8)
        elif max_token < 32768:
            sel_dtype = np.dtype(np.int16)
        else:
            sel_dtype = np.dtype(np.int32)

    seqs, labels = _read_csv(input_path)
    if len(seqs) == 0:
        raise ValueError(f"no valid rows in {input_path}")

    # expand every sequence into (crop_size, start, length) crops —
    # crop-size-major order, matching the reference's row layout
    # (convert.py:1125-1170; pinned live)
    crop_rows: list[tuple[int, int, int, int]] = []  # (seq_idx, crop, start, len)
    for csize, cstride in zip(crop_sizes, stride_list):
        for si, s in enumerate(seqs):
            for start in _crop_starts(len(s), csize, cstride):
                crop_rows.append(
                    (si, csize, start, min(csize, len(s) - start))
                )

    row_labels = np.array([labels[r[0]] for r in crop_rows], dtype=np.int32)
    order = (
        _class_interleaved_permutation(row_labels, shuffle_seed)
        if balance_classes
        else np.arange(len(crop_rows))
    )

    max_crop = max(crop_sizes)
    if shard_size is None and max_memory_mb is not None:
        # RAM-budget dispatch (reference _convert_to_npz_streaming):
        # shard so one materialized shard stays inside the budget
        per_row = 6 * max_crop * sel_dtype.itemsize + 64
        shard_size = max(1024, int(max_memory_mb * 2**20 / per_row))

    def materialize(rows_idx: np.ndarray) -> dict:
        n = len(rows_idx)
        bases = np.full((n, max_crop), 4, dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        out_labels = np.zeros(n, dtype=np.int32)
        for j, ri in enumerate(rows_idx):
            si, csize, start, length = crop_rows[ri]
            bases[j, :length] = seqs[si][start : start + length]
            lengths[j] = length
            out_labels[j] = labels[si]
        data: dict = {"labels": out_labels, "lengths": lengths}
        if fmt in ("translated", "both"):
            toks = encode_translated_batch(
                bases, lengths, max_crop, codon_map
            )
            tl = valid_codon_lengths(lengths, max_crop, dicodon)
            data["translated_lengths"] = tl
            toks = toks.astype(sel_dtype, copy=False)
            if not pad:
                obj = np.empty(n, dtype=object)
                for j in range(n):
                    obj[j] = toks[j, :, : tl[j]]
                data["translated"] = obj
            else:
                data["translated"] = toks
        else:
            data["translated_lengths"] = np.zeros(n, dtype=np.int32)
        if fmt in ("nucleotide", "both"):
            nuc = encode_nucleotide_batch(
                bases, lengths, max_crop, nmap, one_hot, pad_int
            )
            nuc = nuc.astype(sel_dtype, copy=False)
            if not pad:
                obj = np.empty(n, dtype=object)
                for j in range(n):
                    obj[j] = nuc[j, :, : lengths[j]]
                data["nucleotide"] = obj
            else:
                data["nucleotide"] = nuc
        return data

    # archive metadata at reference layout parity (convert.py:1125-1180):
    # crop grid, pad sentinel/flag alongside the encoding maps
    meta = {
        "crop_sizes": np.asarray(crop_sizes, dtype=np.int64),
        "strides": np.asarray(stride_list, dtype=np.int64),
        "pad_int": np.asarray(pad_int),
        "padded": np.asarray(bool(pad)),
    }
    if fmt in ("translated", "both"):
        meta["codon_map"] = np.str_(codon_map)
    if fmt in ("nucleotide", "both"):
        meta["nucleotide_map"] = np.str_(
            json.dumps(nmap or _DEFAULT_NUCLEOTIDE_MAP)
        )

    def materialize_many(chunks: list[np.ndarray]) -> list[dict]:
        if workers and workers > 1 and len(chunks) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as ex:
                return list(ex.map(materialize, chunks))
        return [materialize(c) for c in chunks]

    if shard_size:
        chunks = [
            order[lo : lo + shard_size]
            for lo in range(0, len(order), shard_size)
        ]
        shards = []
        payload: dict = {}
        for shard_i, data in enumerate(materialize_many(chunks)):
            for key, arr in data.items():
                payload[f"{key}_{shard_i:05d}"] = arr
            shards.append({"index": shard_i,
                           "rows": len(chunks[shard_i])})
        manifest = {
            "version": 1, "shards": shards,
            "keys": sorted({k.rsplit("_", 1)[0] for k in payload}),
        }
        payload["_jaeger_manifest"] = np.str_(json.dumps(manifest))
        payload.update(meta)
        save_npz(output_path, payload, compress)
    else:
        if workers and workers > 1 and len(order) > 4096:
            chunk = -(-len(order) // workers)
            parts = materialize_many([
                order[lo : lo + chunk]
                for lo in range(0, len(order), chunk)
            ])
            data = {
                k: np.concatenate([p[k] for p in parts])
                for k in parts[0]
            }
        else:
            data = materialize(order)
        data.update(meta)
        save_npz(output_path, data, compress)

    classes, counts = np.unique(row_labels, return_counts=True)
    return {
        "rows": len(crop_rows),
        "sequences": len(seqs),
        "class_counts": {int(c): int(n) for c, n in zip(classes, counts)},
        "crop_sizes": crop_sizes,
        "output": str(Path(output_path)),
    }
