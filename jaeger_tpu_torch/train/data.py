"""Copy of `jaeger_tpu/train/data.py`.

Host-side training data pipeline.

Parity targets: the reference's CSV live-preprocessing pipeline
(``commands/train.py:380-450`` TextLineDataset + ``process_string_train``)
and the NPZ loaders (``data/loaders.py:908-1142``). The host only parses
labels and ASCII->int8 base IDs (cheap, vectorizable); codon translation
runs on the device inside the train step, so the host pipeline's job is
just shuffling and batching small uint8 arrays.
"""

from __future__ import annotations

import itertools
import random
from pathlib import Path
from typing import Iterator

import numpy as np

from jaeger_tpu_torch.seqops.windows import BASE_N, encode_ascii


def iter_csv_examples(paths: list[str | Path]) -> Iterator[tuple[int, str]]:
    """Yield (label, sequence) from ``label,sequence`` CSV lines.

    Reference format: ``process_string_train`` splits each line on ','
    with x[0]=label, x[1]=sequence (``seqops/encode.py:108-110``).
    """
    for path in paths:
        with open(path) as fh:
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
                yield label, parts[1]


def batches_from_csv(
    paths: list[str | Path],
    batch_size: int,
    crop_nt: int,
    num_classes: int,
    shuffle_buffer: int = 50000,
    seed: int = 42,
    repeat: bool = True,
    label_map: dict[int, int] | None = None,
    drop_remainder: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Stream shuffled batches of {bases, lengths, labels(one-hot)}."""
    rng = random.Random(seed)

    def epoch_stream():
        while True:
            yield from iter_csv_examples(paths)
            if not repeat:
                return

    stream = epoch_stream()
    buffer: list[tuple[int, str]] = list(itertools.islice(stream, shuffle_buffer))
    rng.shuffle(buffer)

    def next_example():
        try:
            incoming = next(stream)
        except StopIteration:
            incoming = None
        if buffer:
            idx = rng.randrange(len(buffer))
            out = buffer[idx]
            if incoming is not None:
                buffer[idx] = incoming
            else:
                buffer[idx] = buffer[-1]
                buffer.pop()
            return out
        return incoming

    while True:
        rows = []
        for _ in range(batch_size):
            ex = next_example()
            if ex is None:
                break
            rows.append(ex)
        if not rows or (drop_remainder and len(rows) < batch_size):
            return
        bases = np.full((len(rows), crop_nt), BASE_N, dtype=np.uint8)
        lengths = np.zeros(len(rows), dtype=np.int32)
        labels = np.zeros(len(rows), dtype=np.int32)
        for i, (label, seq) in enumerate(rows):
            ids = encode_ascii(seq[:crop_nt])
            bases[i, : ids.shape[0]] = ids
            lengths[i] = ids.shape[0]
            labels[i] = label_map.get(label, label) if label_map else label
        if num_classes <= 1:
            # binary head (reliability): raw 0/1 labels, shape (B, 1)
            out_labels = labels.astype(np.float32)[:, None]
        else:
            out_labels = np.zeros((len(rows), num_classes), dtype=np.float32)
            out_labels[np.arange(len(rows)), labels] = 1.0
        yield {"bases": bases, "lengths": lengths, "labels": out_labels}


def grouped_batches_from_csv(
    paths: list[str | Path],
    batch_size: int,
    num_classes: int,
    crop_nt: int | None = None,
    replica_multiple: int = 1,
    seed: int = 42,
    repeat: bool = True,
    label_map: dict[int, int] | None = None,
    length_buckets: tuple[int, ...] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Group-by-length batching for variable-length training.

    Parity: reference ``commands/train.py:235-303`` (``group_by_window``
    on exact sequence length with replica-divisible batch sizes). Windows
    accumulate per length bucket; a bucket flushes when it reaches
    ``batch_size`` rounded down to a multiple of ``replica_multiple``.
    With ``length_buckets`` lengths round up to the nearest bucket (the
    XLA-friendly variant: few static shapes instead of one per length).
    """
    rng = random.Random(seed)
    eff_batch = max(replica_multiple,
                    (batch_size // replica_multiple) * replica_multiple)
    buckets: dict[int, list[tuple[int, str]]] = {}

    def bucket_of(n: int) -> int:
        if crop_nt is not None:
            n = min(n, crop_nt)
        if length_buckets:
            for b in length_buckets:
                if n <= b:
                    return b
            return length_buckets[-1]
        return n

    def flush(blen: int, count: int | None = None) -> dict[str, np.ndarray]:
        count = count or eff_batch
        rows = buckets[blen][:count]
        buckets[blen] = buckets[blen][count:]
        bases = np.full((len(rows), blen), BASE_N, dtype=np.uint8)
        lengths = np.zeros(len(rows), dtype=np.int32)
        labels = np.zeros(len(rows), dtype=np.int64)
        for i, (label, seq) in enumerate(rows):
            ids = encode_ascii(seq[:blen])
            bases[i, : ids.shape[0]] = ids
            lengths[i] = ids.shape[0]
            labels[i] = label_map.get(label, label) if label_map else label
        if num_classes <= 1:
            out_labels = labels.astype(np.float32)[:, None]
        else:
            out_labels = np.zeros((len(rows), num_classes), np.float32)
            out_labels[np.arange(len(rows)), labels] = 1.0
        return {"bases": bases, "lengths": lengths, "labels": out_labels}

    while True:
        for label, seq in iter_csv_examples(paths):
            blen = bucket_of(len(seq))
            buckets.setdefault(blen, []).append((label, seq))
            if len(buckets[blen]) >= eff_batch:
                yield flush(blen)
        if not repeat:
            # drain leftovers in complete replica-multiples
            for blen in list(buckets):
                while len(buckets[blen]) >= replica_multiple:
                    n = min(eff_batch, (
                        len(buckets[blen]) // replica_multiple
                    ) * replica_multiple)
                    yield flush(blen, n)
            return
        rng.random()  # advance RNG between epochs


def apply_crop_mode(
    batch: dict[str, np.ndarray],
    crop_mode: str,
    crop_sizes_nt: list[int],
    rng: np.random.Generator,
    key: str = "translated",
) -> dict[str, np.ndarray]:
    """Runtime crop augmentation on token batches.

    Parity: reference ``data/loaders.py:505-530`` crop modes — ``sample``
    picks one configured crop per batch, ``range`` a uniform length
    between min and max. Tokens beyond the chosen frame count are zeroed
    (masked), keeping shapes static.
    """
    if crop_mode not in ("sample", "range"):
        return batch
    from jaeger_tpu_torch.seqops import crop as crop_contract

    if crop_mode == "sample":
        nt = int(rng.choice(crop_sizes_nt))
    else:
        nt = int(rng.integers(min(crop_sizes_nt), max(crop_sizes_nt) + 1))
    k = max(1, crop_contract.numpy_frame_length(nt))
    feats = batch[key]
    if feats.shape[-1] > k:
        feats = feats.copy()
        feats[..., k:] = 0
    return {**batch, key: feats}


def load_npz_dataset(path: str | Path, key: str = "translated") -> dict:
    """Load a converter NPZ (dense, object-ragged, or sharded-manifest).

    Layout parity: ``jaeger_tpu/dataops/convert.py`` and the reference's
    ``dataops/convert.py`` output (``data/loaders.py:908-1142`` reader).
    Returns {key, labels, lengths, translated_lengths}.
    """
    data = np.load(path, allow_pickle=True)
    names = set(data.files)
    if "_jaeger_manifest" in names:
        import json

        manifest = json.loads(str(data["_jaeger_manifest"]))
        out: dict[str, np.ndarray] = {}
        for k in manifest["keys"]:
            parts = [
                data[f"{k}_{s['index']:05d}"] for s in manifest["shards"]
            ]
            out[k] = np.concatenate(parts, axis=0)
        return out
    # archive metadata (encoding maps + crop grid) is not row data
    meta = {"codon_map", "crop_sizes", "strides", "pad_int", "padded"}
    return {k: data[k] for k in names if not k.endswith("_map")
            and k not in meta}


def _densify(feats: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Pad a batch of ragged (object) arrays to the batch max length."""
    items = [feats[i] for i in idx]
    max_len = max(a.shape[-1] for a in items)
    out = np.zeros((len(items),) + items[0].shape[:-1] + (max_len,),
                   dtype=items[0].dtype)
    for j, a in enumerate(items):
        out[j, ..., : a.shape[-1]] = a
    return out


def batches_from_npz(
    path: str | Path,
    batch_size: int,
    num_classes: int,
    seed: int = 42,
    repeat: bool = True,
    key: str = "translated",
) -> Iterator[dict[str, np.ndarray]]:
    """Batches from a preprocessed NPZ of frame tokens + labels.

    Handles dense (N, 6, L) arrays, ragged object arrays (padded to the
    batch max — the reference's ragged/densify path), and sharded
    manifests.
    """
    data = load_npz_dataset(path, key)
    feats = data[key]
    ragged = feats.dtype == object
    labels = np.asarray(data["labels"]).astype(np.int64).reshape(-1)
    n = feats.shape[0]
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            batch_feats = (
                _densify(feats, idx) if ragged else feats[idx]
            )
            onehot = np.zeros((batch_size, num_classes), dtype=np.float32)
            onehot[np.arange(batch_size), labels[idx]] = 1.0
            yield {key: batch_feats, "labels": onehot}
        if not repeat:
            return


def resolve_strides(crop_sizes: list[int], strides: list[int] | None,
                    overlap: float | None) -> list[int]:
    """Per-crop strides from explicit strides or overlap fraction.

    Parity: reference ``data/loaders.py:417-432``.
    """
    if strides is not None:
        if len(strides) != len(crop_sizes):
            raise ValueError(
                f"strides ({len(strides)}) must match crop_sizes "
                f"({len(crop_sizes)})"
            )
        return [int(s) for s in strides]
    if overlap is not None:
        return [max(1, int(cs * (1 - overlap))) for cs in crop_sizes]
    return [int(cs) for cs in crop_sizes]


def cropped_batches_from_npz(
    path: str | Path,
    batch_size: int,
    num_classes: int,
    crop_sizes: list[int],
    strides: list[int] | None = None,
    overlap: float | None = None,
    crop_mode: str = "all",
    seed: int = 42,
    repeat: bool = True,
    key: str = "translated",
) -> Iterator[dict[str, np.ndarray]]:
    """Runtime-crop batches from full-length NPZ records.

    Parity: reference ``data/loaders.py:505-530`` crop modes over stored
    full-length token arrays (``crop_sizes`` in token units — codon
    frames for translated records):

    - ``all``: every record fans out to every (crop_size x sliding-start)
      variant per epoch — epoch size grows by the variant count;
    - ``sample``: one uniformly sampled variant per record per epoch;
    - ``range``: one crop of uniform length in [min, max] crop size at a
      uniform start per record per epoch.

    Output shapes are static: (batch, frames, max(crop_sizes)), shorter
    crops zero-padded (token 0 is the mask/pad id).
    """
    if crop_mode not in ("all", "sample", "range"):
        raise ValueError(
            f"invalid crop_mode {crop_mode!r} (use 'all', 'sample' or "
            f"'range')"
        )
    crop_sizes = [int(c) for c in crop_sizes]
    strides_r = resolve_strides(crop_sizes, strides, overlap)
    k_max = max(crop_sizes)

    data = load_npz_dataset(path, key)
    feats = data[key]
    labels = np.asarray(data["labels"]).astype(np.int64).reshape(-1)
    ragged = feats.dtype == object
    n = feats.shape[0]
    lengths = (
        np.array([feats[i].shape[-1] for i in range(n)], dtype=np.int64)
        if ragged
        else np.full(n, feats.shape[-1], dtype=np.int64)
    )

    # fast path: fixed-length records no longer than the single crop
    # produce exactly one identity variant each — use the vectorized
    # loader instead of the per-record copy loop
    if (
        not ragged
        and len(set(crop_sizes)) == 1
        and int(lengths.max(initial=0)) <= k_max
    ):
        yield from batches_from_npz(
            path, batch_size=batch_size, num_classes=num_classes,
            seed=seed, repeat=repeat, key=key,
        )
        return

    rng = np.random.default_rng(seed)

    def record_variants(i: int) -> list[tuple[int, int, int]]:
        ln = int(lengths[i])
        if crop_mode == "sample":
            variants = [
                (cs, start)
                for cs, st in zip(crop_sizes, strides_r)
                for start in _crop_starts(ln, cs, st)
            ]
            cs, start = variants[int(rng.integers(len(variants)))]
            return [(i, start, min(cs, ln - start))]
        if crop_mode == "range":
            lo, hi = min(crop_sizes), max(crop_sizes)
            cs = min(int(rng.integers(lo, hi + 1)), ln)
            start = (
                int(rng.integers(0, ln - cs + 1)) if ln > cs else 0
            )
            return [(i, start, cs)]
        return [
            (i, start, min(cs, ln - start))
            for cs, st in zip(crop_sizes, strides_r)
            for start in _crop_starts(ln, cs, st)
        ]

    while True:
        variants: list[tuple[int, int, int]] = []
        for i in rng.permutation(n):
            variants.extend(record_variants(int(i)))
        order = rng.permutation(len(variants))
        for b0 in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[b0 : b0 + batch_size]
            first = feats[variants[idx[0]][0]]
            out = np.zeros(
                (batch_size,) + first.shape[:-1] + (k_max,),
                dtype=first.dtype if not ragged else np.int32,
            )
            lab = np.zeros(batch_size, np.int64)
            for j, v in enumerate(idx):
                i, start, ln = variants[v]
                crop = feats[i][..., start : start + ln]
                out[j, ..., :ln] = crop
                lab[j] = labels[i]
            onehot = np.zeros((batch_size, num_classes), dtype=np.float32)
            onehot[np.arange(batch_size), lab] = 1.0
            yield {key: out, "labels": onehot}
        if not repeat:
            return


def _crop_starts(seq_len: int, crop_size: int, stride: int,
                 pad_to_max: bool = True) -> list[int]:
    """Sliding-crop starts (a copy of
    ``jaeger_tpu/dataops/convert.py::_crop_starts``)."""
    if stride == 0 or seq_len <= crop_size:
        return [0]
    if pad_to_max:
        starts = list(range(0, seq_len - crop_size + 1, stride))
        if starts[-1] + crop_size < seq_len:
            starts.append(seq_len - crop_size)
    else:
        starts = list(range(0, seq_len, stride))
    return starts


def with_frame_shuffle(
    batches: Iterator[dict[str, np.ndarray]], seed: int = 42
) -> Iterator[dict[str, np.ndarray]]:
    """Add a per-example random 6-frame permutation to each batch.

    Train-time augmentation parity: reference ``seqops/encode.py:175-177``
    (``shuffle_frames: true``) — each example's reading frames
    [f1,f2,f3,r1,r2,r3] are randomly reordered. The permutation rides the
    batch as ``frame_perm`` and is applied on device after encoding
    (``models/builder.py``), so it works for both the raw-bases and
    pre-encoded token paths.
    """
    rng = np.random.default_rng(seed)
    for batch in batches:
        n = next(iter(batch.values())).shape[0]
        perm = np.tile(np.arange(6, dtype=np.int32), (n, 1))
        perm = rng.permuted(perm, axis=1)
        yield {**batch, "frame_perm": perm}


def class_frequency_bias(path: str | Path, kind: str = "softmax",
                         label_map: list | None = None) -> np.ndarray:
    """Final-layer bias from training label frequencies.

    Parity: reference ``nnlib/builder.py:896-950`` (``_get_bias``) —
    softmax: ``log(f / sum f)``; sigmoid: ``log(p/(1-p))`` over
    {negative, positive} counts. Accepts a ``label,sequence`` CSV or a
    converter NPZ; ``label_map`` (old-label -> new-label list) merges
    counts like the reference's ``_correct_label_map``.
    """
    path = str(path)
    if path.endswith(".npz"):
        data = load_npz_dataset(path)
        labels = np.asarray(data["labels"]).reshape(-1).astype(np.int64)
        uniq, counts_arr = np.unique(labels, return_counts=True)
        counts = {int(k): int(v) for k, v in zip(uniq, counts_arr)}
    else:
        counts = {}
        with open(path) as fh:
            for line in fh:
                first = line.split(",", 1)[0]
                try:
                    counts[int(first)] = counts.get(int(first), 0) + 1
                except ValueError:
                    continue
    if label_map:
        merged = {i: 0 for i in range(max(label_map) + 1)}
        for k, v in counts.items():
            if k < len(label_map):
                merged[label_map[k]] += v
        counts = merged
    freq = np.array([counts.get(i, 0) for i in range(max(counts) + 1)],
                    dtype=np.float64)
    freq = np.maximum(freq, 1e-12)
    if kind == "sigmoid":
        if freq.size != 2:
            raise ValueError("sigmoid bias needs {negative, positive} counts")
        p = freq[1] / freq.sum()
        return np.array([np.log(p / (1 - p))], dtype=np.float32)
    return np.log(freq / freq.sum()).astype(np.float32)
