"""Copy of `jaeger_tpu/dataops/reliability_generator.py`.

Reliability (ID/OOD) training-data generation.

Parity target: reference ``dataops/reliability_generator.py:588-...`` —
run the trained classifier over the raw training CSV; high-confidence
correct predictions become ID (label 1), high-confidence wrong ones OOD
(label 0); synthetic corrupted sequences (shuffles, repeats, N-stretches,
chimeras) that the classifier still scores confidently are added as OOD.
Writes ``reliability_train.csv`` / ``reliability_val.csv`` (the
``label,sequence`` format both CSV loaders consume).

The classifier is the port's ``JaegerModel``: its eval forward runs on the
device its parameters live on, on ``bases``/``lengths`` tensors encoded
with the port's ``seqops/windows.py``, so the functions take the model
alone where JAX's take ``(model, variables)``. Everything else is the JAX
module's host code, unchanged: the same seeds give the same draws from the
process-global ``random`` and ``np.random`` (``seqops/synthetic.py``), so
both packages write the same sequences.
"""

from __future__ import annotations

import logging
import random
from pathlib import Path

import numpy as np
import torch

from jaeger_tpu_torch.seqops import synthetic as syn
from jaeger_tpu_torch.seqops.windows import BASE_N, encode_ascii

logger = logging.getLogger("jaeger_tpu_torch")


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _predict_csv_rows(model, rows: list[tuple[int, str]], crop_nt: int,
                      batch_size: int = 512, return_logits: bool = False):
    """Run the classifier over (label, seq) rows -> (pred, conf) arrays
    (plus (logits, probs) when ``return_logits``). Each batch is padded to
    ``batch_size`` rows, as JAX's static shapes are."""
    dev = _device(model)
    preds, confs, all_logits, all_probs = [], [], [], []
    for i in range(0, len(rows), batch_size):
        chunk = rows[i : i + batch_size]
        n = len(chunk)
        bases = np.full((batch_size, crop_nt), BASE_N, dtype=np.uint8)
        lengths = np.zeros(batch_size, dtype=np.int32)
        for j, (_, seq) in enumerate(chunk):
            ids = encode_ascii(seq[:crop_nt])
            bases[j, : ids.shape[0]] = ids
            lengths[j] = ids.shape[0]
        with torch.inference_mode():
            out = model(torch.from_numpy(bases).to(dev),
                        torch.from_numpy(lengths).to(dev),
                        heads=("prediction",))
            logits = out["prediction"][:n].double().cpu().numpy()
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p = p / p.sum(axis=1, keepdims=True)
        preds.append(np.argmax(p, axis=1))
        confs.append(p.max(axis=1))
        if return_logits:
            all_logits.append(logits)
            all_probs.append(p)
    preds = np.concatenate(preds)
    confs = np.concatenate(confs)
    if return_logits:
        return preds, confs, np.concatenate(all_logits), \
            np.concatenate(all_probs)
    return preds, confs


def _num_classes(model, crop_nt: int) -> int:
    """Classifier output width (one tiny forward on an empty batch)."""
    dev = _device(model)
    with torch.inference_mode():
        out = model(torch.full((1, crop_nt), BASE_N, dtype=torch.uint8,
                               device=dev),
                    torch.zeros((1,), dtype=torch.int32, device=dev),
                    heads=("prediction",))
    return int(out["prediction"].shape[-1])


def normalize_perturbations(cfg: dict | None) -> list[dict]:
    """Normalize the flexible perturbation config into specs.

    Schema parity: reference ``synthetic_perturbations.py:37-140`` —
    each key may be a bool or a dict with ``enabled`` + kwargs; shuffle
    supports mode lists (random/dinuc/kmer); n_stretch is opt-in; mix
    builds chimeras from multiple records.
    """
    cfg = cfg or {}

    def enabled(key, default):
        v = cfg.get(key, default)
        if isinstance(v, bool):
            return v, {}
        if isinstance(v, dict):
            return v.get("enabled", True), v
        return bool(v), {}

    specs: list[dict] = []
    on, d = enabled("shuffle", True)
    if on:
        modes = d.get("mode", "random")
        modes = [modes] if isinstance(modes, str) else modes
        for mode in modes:
            if mode == "random":
                specs.append({"name": "shuffle", "fn": syn.apply_shuffle,
                              "kwargs": {}})
            elif mode == "dinuc":
                specs.append({"name": "shuffle",
                              "fn": syn.apply_dinuc_shuffle, "kwargs": {}})
            elif mode == "kmer":
                specs.append({"name": "shuffle",
                              "fn": syn.apply_kmer_shuffle,
                              "kwargs": {"k": d.get("k", 2)}})
            else:
                raise ValueError(f"unsupported shuffle mode {mode!r}")
    on, d = enabled("subseq_repeat", True)
    if on:
        specs.append({
            "name": "subseq_repeat", "fn": syn.apply_subseq_repeat_window,
            "kwargs": {"window_fraction": d.get("window_fraction", 0.25)},
        })
    on, d = enabled("tandem_repeat", True)
    if on:
        specs.append({
            "name": "tandem_repeat", "fn": syn.apply_tandem_repeat_window,
            "kwargs": {
                "motif_length_range": tuple(
                    d.get("motif_length_range", (3, 10))),
                "window_fraction": d.get("window_fraction", 0.25),
                "num_repeats": d.get("num_repeats"),
            },
        })
    on, d = enabled("n_stretch", False)   # opt-in, reference parity
    if on:
        specs.append({
            "name": "n_stretch", "fn": syn.apply_n_stretch,
            "kwargs": {
                "n_fraction_range": tuple(
                    d.get("n_fraction_range", (0.3, 1.0))),
                "max_stretches": d.get("max_stretches", 3),
                "point_n_share": d.get("point_n_share", 0.2),
            },
        })
    on, d = enabled("mix", False)
    if on:
        specs.append({
            "name": "mix", "fn": None,
            "n_segments": d.get("n_segments", 2), "kwargs": {},
        })
    if not specs:
        raise ValueError("no perturbations enabled")
    return specs


def compute_perturbation_counts(records, multiplier: float,
                                specs: list[dict], cfg: dict) -> list[int]:
    """Per-spec sample counts (reference
    ``synthetic_perturbations.py:139-180``): specs whose config carries
    an explicit ``count`` or per-spec ``multiplier`` take it; the
    remaining global budget ``len(records) * multiplier`` splits evenly
    over the implicit specs with the leftover dealt round-robin."""
    n = len(records)
    global_count = max(0, int(n * multiplier))
    if not specs:
        return []
    counts = [0] * len(specs)
    explicit: list[int] = []
    for i, spec in enumerate(specs):
        c = cfg.get(spec["name"], {})
        if isinstance(c, dict):
            if "count" in c:
                counts[i] = max(0, int(c["count"]))
                explicit.append(i)
            elif "multiplier" in c:
                counts[i] = max(0, int(n * c["multiplier"]))
                explicit.append(i)
    implicit = [i for i in range(len(specs)) if i not in explicit]
    if not implicit:
        return counts
    remaining = max(0, global_count - sum(counts[i] for i in explicit))
    per = remaining // len(implicit)
    for i in implicit:
        counts[i] = per
    leftover = remaining - per * len(implicit)
    for i in range(leftover):
        counts[implicit[i % len(implicit)]] += 1
    return counts


def _generate_chunk(records, spec: dict, count: int,
                    crop_size: int | None, seed: int) -> list[str]:
    """One seeded chunk for one spec (reference
    ``synthetic_perturbations.py:212-239``, RNG stream-identical):
    non-mix specs walk ``records[i % n]`` in order; mix samples
    ``n_segments`` distinct class labels per chimera."""
    random.seed(seed)
    np.random.seed(seed)
    out: list[str] = []
    if spec["name"] == "mix":
        label_to_seqs: dict[int, list[str]] = {}
        for label, seq in records:
            label_to_seqs.setdefault(label, []).append(seq)
        labels = list(label_to_seqs)
        n_segments = spec["n_segments"]
        if len(labels) < n_segments:
            raise ValueError(
                f"mix perturbation requires at least {n_segments} "
                f"distinct classes, found {len(labels)}"
            )
        for _ in range(count):
            chosen = random.sample(labels, k=n_segments)
            seqs = [random.choice(label_to_seqs[la]) for la in chosen]
            out.append(syn.apply_mix(seqs, output_length=crop_size))
    else:
        fn, kwargs, n = spec["fn"], spec["kwargs"], len(records)
        for i in range(count):
            _, seq = records[i % n]
            out.append(fn(seq, **kwargs))
    return out


def generate_synthetic_sequences(records: list[tuple[int, str]],
                                 multiplier: float,
                                 perturbations: dict | None = None,
                                 crop_size: int | None = None,
                                 seed: int = 42,
                                 generation_chunk_size: int = 10_000,
                                 ) -> list[str]:
    """Corrupted variants of real sequences.

    Reference-identical (``dataops/synthetic_perturbations.py:319-415``,
    pinned live seed-for-seed in ``tests/test_synthetic_live_parity.py``):
    the per-spec budget comes from :func:`compute_perturbation_counts`,
    each spec generates in ``generation_chunk_size`` chunks seeded
    ``seed + chunk_offset`` — so datasets regenerate identically at any
    chunking, without the reference's subprocess machinery (generation
    here is pure host work off the device path; chunk seeding keeps the
    memory-bounded restartability its workers provided).
    """
    cfg = perturbations or {}
    specs = normalize_perturbations(cfg)
    counts = compute_perturbation_counts(records, multiplier, specs, cfg)
    out: list[str] = []
    offset = 0
    for spec, count in zip(specs, counts):
        if count <= 0:
            continue
        for start in range(0, count, generation_chunk_size):
            sub = min(generation_chunk_size, count - start)
            out.extend(
                _generate_chunk(records, spec, sub, crop_size,
                                seed + offset)
            )
            offset += 1
    return out


def downsample_to_match(real_records: list[tuple[int, str]],
                        synthetic_records: list[tuple[int, str]],
                        rng: np.random.Generator) -> list[tuple[int, str]]:
    """Stratified downsample of real records to the synthetic count.

    RNG-call-identical to the reference's ``_downsample_to_match``
    (``dataops/reliability_generator.py:485-520``; pinned seed-for-seed
    in ``tests/test_relgen_live_parity.py``): per-label targets are
    ``round(n_synth * label_fraction)``, rounding gaps fill one index at
    a time, and the result is shuffled.
    """
    n_real, n_synth = len(real_records), len(synthetic_records)
    if n_real <= n_synth or n_synth == 0:
        return real_records
    labels = np.array([label for label, _ in real_records], dtype=np.int32)
    kept: list[int] = []
    for label in np.unique(labels):
        idx = np.where(labels == label)[0]
        n_target = int(round(n_synth * len(idx) / n_real))
        if n_target > 0:
            kept.extend(rng.choice(idx, size=n_target,
                                   replace=False).tolist())
    while len(kept) < n_synth:
        remaining = [i for i in range(n_real) if i not in kept]
        if not remaining:
            break
        kept.append(int(rng.choice(remaining)))
    rng.shuffle(kept)
    return [real_records[i] for i in kept]


def sample_records_for_synthetic_generation(
    records: list[tuple[int, str]], target_size: int,
    rng: np.random.Generator,
) -> list[tuple[int, str]]:
    """Stratified source sample for synthetic generation.

    RNG-call-identical to the reference's
    ``_sample_records_for_synthetic_generation``
    (``dataops/reliability_generator.py:523-555``; pinned seed-for-seed):
    per-label targets keep at least one record, overshoot trims by
    shuffle+pop, and the result is shuffled.
    """
    n = len(records)
    if n <= target_size:
        return records
    labels = np.array([label for label, _ in records], dtype=np.int32)
    kept: list[int] = []
    for label in np.unique(labels):
        idx = np.where(labels == label)[0]
        n_target = max(1, int(round(target_size * len(idx) / n)))
        if n_target >= len(idx):
            kept.extend(idx.tolist())
        else:
            kept.extend(rng.choice(idx, size=n_target,
                                   replace=False).tolist())
    while len(kept) > target_size:
        rng.shuffle(kept)
        kept.pop()
    rng.shuffle(kept)
    return [records[i] for i in kept]


def prediction_csv_header(num_classes: int) -> list[str]:
    """Reference ``_prediction_csv_header`` column order
    (``dataops/reliability_generator.py:381-386``)."""
    return (["seq_id", "label"]
            + [f"logit_{i}" for i in range(num_classes)]
            + [f"prob_{i}" for i in range(num_classes)])


def _load_predictions_csv(path: Path, expected_labels: np.ndarray,
                          num_classes: int) -> np.ndarray | None:
    """Reuse an existing predictions CSV when its rows and labels match
    (reference resume semantics, ``reliability_generator.py:262-348``);
    returns the probability matrix or ``None`` to recompute."""
    try:
        with open(path) as fh:
            header = fh.readline().strip().split(",")
            if header[:2] != ["seq_id", "label"]:
                return None
            rows = [ln.rstrip("\n").split(",") for ln in fh if ln.strip()]
    except OSError:
        return None
    if len(rows) != len(expected_labels):
        logger.warning(
            f"existing {path.name} has {len(rows)} rows, expected "
            f"{len(expected_labels)}; recomputing")
        return None
    try:
        labels = np.array([int(r[1]) for r in rows], dtype=np.int32)
        probs = np.array(
            [[float(v) for v in r[2 + num_classes: 2 + 2 * num_classes]]
             for r in rows], dtype=np.float64)
    except (ValueError, IndexError):
        return None
    if probs.shape[1] != num_classes or not np.array_equal(
            labels, expected_labels):
        logger.warning(f"{path.name} does not match records; recomputing")
        return None
    logger.info(f"reusing predictions from {path}")
    return probs


def generate_reliability_data(
    model,
    raw_csv_path: str,
    output_dir: str,
    crop_nt: int,
    id_threshold: float = 0.8,
    synthetic_ood_threshold: float = 0.8,
    synthetic_ood_multiplier: float = 1.0,
    val_fraction: float = 0.1,
    seed: int = 42,
    batch_size: int = 512,
    perturbations: dict | None = None,
    chunk_size: int = 100_000,
    raw_val_csv_path: str | None = None,
    synthetic_source_sample_size: int | None = None,
    balance_to_synthetic: bool = True,
    write_predictions: bool = True,
) -> dict:
    """Build reliability CSVs; returns the builder-shaped paths dict.

    Reference semantics (``dataops/reliability_generator.py:588-907``)
    with a streaming engine: the raw CSV is classified in
    ``chunk_size``-row chunks (confident-correct -> ID(1),
    confident-wrong -> OOD(0)); synthetic perturbed sequences generated
    FROM each chunk are kept as OOD only when the classifier is still
    confident on them; real records are stratified-downsampled to the
    surviving synthetic count (:func:`downsample_to_match`); a dedicated
    ``raw_val_csv_path`` is processed the same way when given, otherwise
    the pool is shuffled and split at ``val_fraction`` (reference
    order: val first). A self-describing ``<stem>_preds.csv``
    (seq_id/label/logits/probs) is written per input and reused on
    rerun when rows+labels match. Divergences (documented): our RNG is
    seeded (the reference's is not, so its outputs are irreproducible),
    and ``synthetic_source_sample_size`` applies per chunk (stratified,
    multiplier rescaled) instead of globally, keeping memory bounded.
    """
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    train_csv = output_dir / "reliability_train.csv"
    val_csv = output_dir / "reliability_val.csv"
    if train_csv.exists() and val_csv.exists():
        logger.info(f"reliability data already exists in {output_dir}")
        return {
            "train": {"paths": [str(train_csv)], "class": [], "label": []},
            "validation": {"paths": [str(val_csv)], "class": [], "label": []},
        }

    rng = np.random.default_rng(seed)

    def read_chunks(path):
        """Yield (rows, seq_ids) in chunk_size chunks; the last CSV
        column is the sequence id when >= 3 columns (reference
        ``_read_csv_records_with_ids``)."""
        chunk: list[tuple[int, str]] = []
        ids: list[str] = []
        row_no = 0
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split(",")
                if len(parts) >= 2:
                    try:
                        chunk.append((int(parts[0]), parts[1]))
                    except ValueError:
                        continue
                    ids.append(parts[-1] if len(parts) >= 3 else str(row_no))
                    row_no += 1
                if len(chunk) >= chunk_size:
                    yield chunk, ids
                    chunk, ids = [], []
        if chunk:
            yield chunk, ids

    def process_csv(path):
        """Classify one CSV -> (id_records, ood_records, synth_kept)."""
        id_records: list[tuple[int, str]] = []
        ood_records: list[tuple[int, str]] = []
        synth_kept: list[tuple[int, str]] = []
        n_rows = n_synth = 0
        preds_path = output_dir / (Path(path).stem + "_preds.csv")

        cached_probs = None
        if write_predictions and preds_path.exists():
            all_labels = np.array(
                [lab for rows, _ in read_chunks(path) for lab, _ in rows],
                dtype=np.int32)
            num_classes = _num_classes(model, crop_nt)
            cached_probs = _load_predictions_csv(
                preds_path, all_labels, num_classes)

        preds_rows: list[str] = []
        for ci, (rows, seq_ids) in enumerate(read_chunks(path)):
            if cached_probs is not None:
                probs = cached_probs[n_rows: n_rows + len(rows)]
                preds = np.argmax(probs, axis=1)
                confs = probs.max(axis=1)
            else:
                preds, confs, logits, probs = _predict_csv_rows(
                    model, rows, crop_nt, batch_size,
                    return_logits=True)
                if write_predictions:
                    for sid, (lab, _), lg, pr in zip(
                            seq_ids, rows, logits, probs):
                        preds_rows.append(
                            f"{sid},{lab},"
                            + ",".join(f"{v:.7g}" for v in lg) + ","
                            + ",".join(f"{v:.7g}" for v in pr))
            n_rows += len(rows)
            for (label, seq), pred, conf in zip(rows, preds, confs):
                if conf < id_threshold:
                    continue
                if pred == label:
                    id_records.append((1, seq))
                else:
                    ood_records.append((0, seq))

            src, mult = rows, synthetic_ood_multiplier
            if (synthetic_source_sample_size is not None
                    and synthetic_source_sample_size < len(rows)):
                src = sample_records_for_synthetic_generation(
                    rows, synthetic_source_sample_size, rng)
                mult = synthetic_ood_multiplier * (len(rows) / len(src))
            synth = generate_synthetic_sequences(
                src, mult, perturbations, crop_size=crop_nt, seed=seed + ci)
            n_synth += len(synth)
            synth_rows = [(0, s) for s in synth]
            _, s_confs = _predict_csv_rows(
                model, synth_rows, crop_nt, batch_size)
            for (_, seq), conf in zip(synth_rows, s_confs):
                # kept only when the classifier is (wrongly) confident
                if conf >= synthetic_ood_threshold:
                    synth_kept.append((0, seq))

        if write_predictions and cached_probs is None and preds_rows:
            num_classes = (len(preds_rows[0].split(",")) - 2) // 2
            with open(preds_path, "w") as fh:
                fh.write(",".join(prediction_csv_header(num_classes)) + "\n")
                fh.write("\n".join(preds_rows) + "\n")
            logger.info(f"wrote predictions to {preds_path}")
        if n_rows == 0:
            raise ValueError(f"no records in {path}")
        logger.info(
            f"{Path(path).name}: {len(id_records)} ID, "
            f"{len(ood_records)} real OOD, "
            f"{len(synth_kept)}/{n_synth} synthetic OOD kept")
        return id_records, ood_records, synth_kept

    id_recs, ood_recs, synth_recs = process_csv(raw_csv_path)
    real = id_recs + ood_recs
    if balance_to_synthetic:
        before = len(real)
        real = downsample_to_match(real, synth_recs, rng)
        if len(real) < before:
            logger.info(
                f"downsampled real records {before} -> {len(real)} to "
                f"match {len(synth_recs)} synthetic OOD")

    if raw_val_csv_path:
        v_id, v_ood, v_synth = process_csv(raw_val_csv_path)
        v_real = v_id + v_ood
        if balance_to_synthetic:
            v_real = downsample_to_match(v_real, v_synth, rng)
        val_records = v_real + v_synth
        train_records = real + synth_recs
        rng.shuffle(train_records)
    else:
        pool = real + synth_recs
        rng.shuffle(pool)
        n_val = int(len(pool) * val_fraction)
        val_records, train_records = pool[:n_val], pool[n_val:]

    for recs, path in ((train_records, train_csv), (val_records, val_csv)):
        with open(path, "w") as fh:
            for label, seq in recs:
                fh.write(f"{label},{seq}\n")
    return {
        "train": {"paths": [str(train_csv)], "class": [], "label": []},
        "validation": {"paths": [str(val_csv)], "class": [], "label": []},
    }
