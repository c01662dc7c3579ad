"""Copy of `jaeger_tpu/commands/taxonomy.py`, with the k-NN search on torch.

Experimental embedding-based taxonomy assignment. ``build``: run the
model's ``embedding`` output over reference-genome windows and index the
L2-normalized embeddings; ``predict``: embed query windows, find their k
nearest index windows by cosine similarity, and take the majority-fraction
LCA per contig over an in-repo NCBI-taxdump walker.

The forward runs through the port's ``InferenceEngine`` (the residual
convs on the ``fused_conv_block`` kernel on the card). The search is one
matmul of the normalized queries against the index and a top-k, on the
same device, with ties broken toward the lower index row as
``jax.lax.top_k`` breaks them. Over several devices (a ``DeviceMesh``)
the index rows are sharded and the local top-k lists merged, with the
one-device results (``CosineIndex._search_sharded``).
"""

from __future__ import annotations

import json
import logging
from collections import Counter
from pathlib import Path

import numpy as np

logger = logging.getLogger("jaeger_tpu_torch")

#: reference rank-prefix table for the full-lineage string
#: (``commands/taxonomy.py:36-69``)
_RANK_PREFIXES = {
    "superkingdom": "d", "kingdom": "k", "subkingdom": "sk",
    "superphylum": "sp", "phylum": "p", "subphylum": "sph",
    "superclass": "sc", "class": "c", "subclass": "ssc",
    "infraclass": "ic", "superorder": "so", "order": "o",
    "suborder": "sor", "infraorder": "io", "parvorder": "po",
    "superfamily": "sf", "family": "f", "subfamily": "sfa",
    "tribe": "t", "subtribe": "st", "genus": "g", "subgenus": "sg",
    "species group": "sg", "species subgroup": "ssg", "species": "s",
    "subspecies": "ss", "strain": "str", "varietas": "v", "forma": "fo",
    "realm": "r", "subrealm": "sr",
}

#: score-matrix elements one search chunk may hold (1 GiB of f32)
SEARCH_CHUNK_ELEMENTS = 1 << 28


# ---------------------------------------------------------------------------
# Minimal NCBI taxdump handling (replaces taxopy)
# ---------------------------------------------------------------------------


class TaxDb:
    """parent/rank/name maps from nodes.dmp + names.dmp."""

    def __init__(self, taxdump_dir: str | Path):
        taxdump_dir = Path(taxdump_dir)
        self.parent: dict[int, int] = {}
        self.rank: dict[int, str] = {}
        self.name: dict[int, str] = {}
        with open(taxdump_dir / "nodes.dmp") as fh:
            for line in fh:
                parts = [p.strip() for p in line.split("|")]
                taxid, parent, rank = int(parts[0]), int(parts[1]), parts[2]
                self.parent[taxid] = parent
                self.rank[taxid] = rank
        names_path = taxdump_dir / "names.dmp"
        if names_path.exists():
            with open(names_path) as fh:
                for line in fh:
                    parts = [p.strip() for p in line.split("|")]
                    if len(parts) > 3 and parts[3] == "scientific name":
                        self.name[int(parts[0])] = parts[1]

    def lineage(self, taxid: int) -> list[int]:
        """Root -> taxid path."""
        path = []
        seen = set()
        while taxid not in seen:
            seen.add(taxid)
            path.append(taxid)
            parent = self.parent.get(taxid)
            if parent is None or parent == taxid:
                break
            taxid = parent
        return path[::-1]

    def majority_lca(self, taxids: list[int], fraction: float = 0.6) -> int:
        """Deepest taxon on >= ``fraction`` of the lineages.

        Parity with taxopy's majority-vote LCA used at reference
        ``taxonomy.py:115-151``.
        """
        taxids = [t for t in taxids if t in self.parent]
        if not taxids:
            return 1
        n = len(taxids)
        counts: Counter[int] = Counter()
        for t in taxids:
            counts.update(set(self.lineage(t)))
        eligible = [t for t, c in counts.items() if c / n >= fraction]
        if not eligible:
            return 1
        return max(eligible, key=lambda t: len(self.lineage(t)))

    def lineage_names(self, taxid: int) -> str:
        return ";".join(
            self.name.get(t, str(t)) for t in self.lineage(taxid)
            if self.rank.get(t) != "no rank" or t == taxid
        )

    def ranked_lineage(self, taxid: int) -> str:
        """``d__Name;p__Name;...`` lineage string at reference format
        (``commands/taxonomy.py:36-78``): ranked nodes only, leaf ->
        root order like taxopy's ``rank_name_dictionary``, each
        prefixed with the reference's abbreviated rank code."""
        parts = []
        for t in reversed(self.lineage(taxid)):
            rank = self.rank.get(t, "")
            if rank in ("", "no rank"):
                continue
            prefix = _RANK_PREFIXES.get(rank, rank[0] if rank else "?")
            parts.append(f"{prefix}__{self.name.get(t, str(t))}")
        return ";".join(parts)


# ---------------------------------------------------------------------------
# Cosine index (device matmul + top-k)
# ---------------------------------------------------------------------------


def _l2_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def topk_lower_index(sims, k: int):
    """Top ``k`` of each row of ``sims`` -> (scores, indices), by score
    descending, equal scores with the lower column first; the columns
    kept at a tie on the k-th score are the lowest ones. That is
    ``jax.lax.top_k``'s order; ``torch.topk`` promises none for ties, so
    only its k-th value is used, and the selection is made from it."""
    import torch

    kth = torch.topk(sims, k, dim=1).values[:, -1:]
    keep = sims >= kth
    over = keep.sum(dim=1) > k
    if bool(over.any()):
        # rows with more ties at the k-th score than places left: keep the
        # lowest columns of the tied ones
        rows = over.nonzero().squeeze(1)
        tied = sims[rows] == kth[rows]
        room = k - (sims[rows] > kth[rows]).sum(dim=1, keepdim=True)
        keep[rows] = (sims[rows] > kth[rows]) | (
            tied & (tied.cumsum(dim=1, dtype=torch.int32) <= room))
    idx = keep.nonzero()[:, 1].view(-1, k)            # ascending columns
    scores = sims.gather(1, idx)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return scores, idx.gather(1, order)


def _merge_shards(chunk, k: int, index: list, devices: list, n: int):
    """One query chunk's global top-k from the index shards: local top-k a
    shard, then the stable merge on ``devices[0]``."""
    import torch

    home = devices[0]
    per = index[0].shape[0]
    s_all, g_all = [], []
    for r, (x, dev) in enumerate(zip(index, devices)):
        sims = chunk.to(dev) @ x.T                          # (B, per)
        gid = r * per + torch.arange(per, device=dev)
        sims = torch.where(gid[None, :] < n, sims,
                           torch.full((), -torch.inf, device=dev))
        s, i = topk_lower_index(sims, min(k, per))
        s_all.append(s.to(home))
        g_all.append((i + r * per).to(home))
    s_all = torch.cat(s_all, dim=1)
    g_all = torch.cat(g_all, dim=1)
    order = torch.sort(s_all, dim=1, descending=True,
                       stable=True).indices[:, :k]
    return s_all.gather(1, order), g_all.gather(1, order)


class CosineIndex:
    """Flat cosine index: one matmul + top-k per chunk of queries.

    The normalized rows stay in numpy f32, as in JAX; ``search`` moves
    them to ``device`` (``cuda`` by default) and runs the product there in
    full f32 (TF32 off, as ``resolve_device`` sets it). Queries go in
    chunks so that one chunk's score matrix holds at most
    ``SEARCH_CHUNK_ELEMENTS``; past one chunk the last is padded with zero
    rows, so every product has the same shape.
    """

    def __init__(self, embeddings: np.ndarray, taxids: np.ndarray):
        self.embeddings = _l2_normalize(
            np.asarray(embeddings, np.float32)
        )
        self.taxids = np.asarray(taxids, np.int64)

    def search(self, queries: np.ndarray, k: int = 5, device=None,
               mesh=None):
        """(scores, indices) of each query's ``k`` nearest index rows. With
        ``mesh`` (a :class:`~jaeger_tpu_torch.parallel.mesh.DeviceMesh`)
        the index rows are sharded over its devices
        (:meth:`_search_sharded`), with the same results."""
        from jaeger_tpu_torch.utils.devices import resolve_device

        n = self.embeddings.shape[0]
        k = min(k, n)
        q = _l2_normalize(np.asarray(queries, np.float32))
        n_q = q.shape[0]
        if k == 0:
            return np.zeros((n_q, 0), np.float32), np.zeros((n_q, 0), np.int64)
        if mesh is not None:
            return self._search_sharded(q, k, mesh)
        return self._search(q, k, [self.embeddings], [resolve_device(device)])

    def _search_sharded(self, q: np.ndarray, k: int, mesh):
        """Row-sharded search of normalized queries ``q``, as
        `jaeger_tpu/commands/taxonomy.py::_search_sharded`: device ``d``
        holds index rows ``[d·R, (d+1)·R)`` (``R = ceil(n / N)``, zero rows
        past ``n``); see :meth:`_search`."""
        n, d = self.embeddings.shape
        per = -(-n // mesh.size)
        padded = np.zeros((per * mesh.size, d), np.float32)
        padded[:n] = self.embeddings
        return self._search(
            q, k, [padded[i * per:(i + 1) * per] for i in range(mesh.size)],
            list(mesh.devices))

    def _search(self, q: np.ndarray, k: int, shards: list, devices: list):
        """The search over index ``shards`` (equal row counts, shard ``r``
        on ``devices[r]``), queries in chunks of at most
        ``SEARCH_CHUNK_ELEMENTS`` scores a shard. The whole index on one
        device: one product and :func:`topk_lower_index`. Sharded: each
        device's local top-k (rows past ``n`` score ``-inf``, so they
        never win), the lists gathered on the first device in shard order
        and merged by a stable descending sort, so equal scores keep the
        lower global row first, as the one-device search orders them."""
        import torch

        from jaeger_tpu_torch.utils.devices import resolve_device

        n = self.embeddings.shape[0]
        n_q = q.shape[0]
        per = shards[0].shape[0]
        devices = [resolve_device(d) for d in devices]
        index = [torch.from_numpy(x).to(d) for x, d in zip(shards, devices)]
        whole = len(shards) == 1 and per == n
        rows = max(1, SEARCH_CHUNK_ELEMENTS // per)
        if q.shape[0] > rows and q.shape[0] % rows:
            # every chunk the same shape, so the product takes the same
            # route for each, wherever a query row lands
            q = np.concatenate([q, np.zeros((rows - q.shape[0] % rows,
                                             q.shape[1]), np.float32)])
        scores, idx = [], []
        for lo in range(0, q.shape[0], rows):
            chunk = torch.from_numpy(q[lo: lo + rows])
            if whole:
                s, i = topk_lower_index(chunk.to(devices[0]) @ index[0].T, k)
            else:
                s, i = _merge_shards(chunk, k, index, devices, n)
            scores.append(s.cpu().numpy())
            idx.append(i.cpu().numpy())
        if not scores:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
        return (np.concatenate(scores)[:n_q], np.concatenate(idx)[:n_q])

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path, embeddings=self.embeddings, taxids=self.taxids
        )

    @classmethod
    def load(cls, path: str | Path) -> "CosineIndex":
        data = np.load(path)
        return cls(data["embeddings"], data["taxids"])


# ---------------------------------------------------------------------------
# Build / predict
# ---------------------------------------------------------------------------


def _embed_fasta(model_path: str, fasta: str, fsize: int, batch: int,
                 precision: str = "bfloat16", stride: int | None = None,
                 workers: int = 0, device=None):
    """(per-window embeddings as f32, per-window contig headers)."""
    import torch

    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.postprocess.collect import PredictionMeta
    from jaeger_tpu_torch.seqops.windows import window_batches

    # as in JAX's taxonomy: only the bf names select bf16
    dtype = torch.bfloat16 if precision.startswith("bf") else torch.float32
    model, _config, _ = load_model(model_path, dtype=dtype, device=device)
    # the engine returns every output as f32 (a bf16 embedding is cast on
    # the device, before numpy, which has no bf16)
    engine = InferenceEngine(model, batch_size=batch, device=device,
                             output_keys=("embedding",))
    outputs, kept = engine.predict_batches(
        window_batches(fasta, fragsize=fsize,
                       stride=(stride or fsize), workers=workers)
    )
    if not outputs:
        raise ValueError(f"no windows produced from {fasta}")
    meta = PredictionMeta.from_batches(kept)
    return outputs["embedding"], np.asarray(meta.headers, dtype=str)


def build_taxdb(
    model_path: str,
    fasta: str,
    acc2taxid: str,
    taxdump_dir: str,
    out_dir: str,
    fsize: int = 2000,
    batch: int = 256,
    stride: int | None = None,
    precision: str = "bfloat16",
    workers: int = 0,
    overwrite: bool = False,
    device=None,
) -> Path:
    """Embed reference genomes and build the cosine taxonomy index.

    ``acc2taxid`` is a 2-column TSV mapping contig accession -> taxid
    (reference ``taxonomy.py:243-253``).
    """
    out_dir = Path(out_dir)
    if (out_dir / "genomes_index.npz").exists() and not overwrite:
        raise SystemExit(
            f"taxonomy db already exists at {out_dir}; use -f/--overwrite")
    out_dir.mkdir(parents=True, exist_ok=True)
    mapping: dict[str, int] = {}
    with open(acc2taxid) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                try:
                    mapping[parts[0]] = int(parts[1])
                except ValueError:
                    continue

    embeddings, headers = _embed_fasta(model_path, fasta, fsize, batch,
                                       precision=precision, stride=stride,
                                       workers=workers, device=device)
    taxids = np.array(
        [mapping.get(h.split()[0], 0) for h in headers], np.int64
    )
    keep = taxids > 0
    index = CosineIndex(embeddings[keep], taxids[keep])
    index.save(out_dir / "genomes_index.npz")

    # stage the taxdump files the predictor needs
    tax_dir = out_dir / "tax"
    tax_dir.mkdir(exist_ok=True)
    for name in ("nodes.dmp", "names.dmp"):
        src = Path(taxdump_dir) / name
        if src.exists():
            (tax_dir / name).write_bytes(src.read_bytes())
    (out_dir / "taxdb.json").write_text(json.dumps({
        "model": str(model_path), "fsize": fsize,
        "windows": int(keep.sum()),
    }))
    logger.info(f"taxonomy db built: {int(keep.sum())} indexed windows")
    return out_dir


def predict_taxonomy(
    model_path: str,
    db_dir: str,
    fasta: str,
    output: str,
    k: int = 5,
    fraction: float = 0.6,
    fsize: int = 2000,
    batch: int = 256,
    stride: int | None = None,
    precision: str = "bfloat16",
    workers: int = 0,
    overwrite: bool = False,
    device=None,
    mesh=None,
) -> Path:
    """Assign a lineage per contig via embedding k-NN + majority LCA.
    ``mesh`` (a :class:`~jaeger_tpu_torch.parallel.mesh.DeviceMesh`)
    shards the index search over its devices; by default
    the search shards over every visible card of a bare ``cuda``."""
    db_dir = Path(db_dir)
    index = CosineIndex.load(db_dir / "genomes_index.npz")
    taxdb = TaxDb(db_dir / "tax")

    embeddings, headers = _embed_fasta(model_path, fasta, fsize, batch,
                                       precision=precision, stride=stride,
                                       workers=workers, device=device)
    # shard the index rows over every visible card (capacity scales with
    # the mesh; the results are those of the one-device search)
    if mesh is None:
        from jaeger_tpu_torch.parallel.mesh import mesh_of, visible_width
        from jaeger_tpu_torch.utils.devices import resolve_device

        dev = resolve_device(device)
        width = visible_width(dev, 1)
        if width > 1:
            mesh = mesh_of(dev, width, "data")
    scores, idx = index.search(embeddings, k=k, device=device, mesh=mesh)
    window_taxids = index.taxids[idx]  # (n, k)

    rows = []
    for contig in dict.fromkeys(headers):
        m = headers == contig
        votes = window_taxids[m].reshape(-1).tolist()
        lca = taxdb.majority_lca(votes, fraction=fraction)
        rows.append({
            "contig_id": contig,
            "taxid": lca,
            "rank": taxdb.rank.get(lca, ""),
            "name": taxdb.name.get(lca, str(lca)),
            "lineage": taxdb.ranked_lineage(lca),
            "n_windows": int(m.sum()),
            "mean_knn_similarity": float(scores[m].mean()),
        })
    import pandas as pd

    df = pd.DataFrame(rows)
    output = Path(output)
    if output.exists() and not overwrite:
        raise SystemExit(
            f"output {output} already exists; use -f/--overwrite")
    output.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(output, sep="\t", index=False, float_format="%.4f")
    logger.info(f"taxonomy predictions written to {output}")
    return output
