"""A metagenome assembly as ``predict`` meets it, written from the seed.

Contigs of ``min_len`` to ``max_len`` bases (the length mix of an
assembly's contigs past a few kb), random A, C, G, T. One contig in
``n_every`` holds a run of N of ``n_min`` to ``n_max`` bases (a scaffold
gap: its windows take the masked program), one in ``lc_every`` a
low-complexity tract of ``lc_min`` to ``lc_max`` bases (DUST masks it).
Every seed gets the same lengths, gap widths and tract widths, in another
order and at other places, so the work is the same and only the bases
differ. Lines of 80 bases, headers ``>ctg_<i> len=<n>``.

The tract units and the layout follow ``chip_smoke.py``'s
``write_synthetic_fasta``. The mix is provisional: its lengths and gaps
are not taken from a public assembly's statistics.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

UNITS = (b"A", b"CA", b"CAG", b"TTAGGG")


def _spread(lo: int, hi: int, n: int) -> np.ndarray:
    return np.round(np.linspace(lo, hi, max(n, 1))).astype(np.int64)


def make(params: dict, seed: int, workdir: Path) -> dict:
    """Write ``assembly.fasta`` under ``workdir``. Returns its ``path``
    and each contig's bases (``seqs``, ASCII ``uint8``)."""
    rng = np.random.default_rng(seed)
    n = int(params["contigs"])
    lengths = rng.permutation(_spread(params["min_len"], params["max_len"], n))
    gapped = rng.permutation(n)[: n // int(params["n_every"])]
    gap_w = rng.permutation(_spread(params["n_min"], params["n_max"], len(gapped)))
    tracts = rng.permutation(n)[: n // int(params["lc_every"])]
    tract_w = rng.permutation(_spread(params["lc_min"], params["lc_max"], len(tracts)))
    gaps = dict(zip(gapped.tolist(), gap_w.tolist()))
    lcs = dict(zip(tracts.tolist(), tract_w.tolist()))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    path = Path(workdir) / "assembly.fasta"
    with open(path, "wb") as fh:
        for i, length in enumerate(lengths.tolist()):
            seq = acgt[rng.integers(0, 4, size=length)]
            if i in gaps:
                w = gaps[i]
                at = int(rng.integers(0, length - w))
                seq[at: at + w] = ord("N")
            if i in lcs:
                w = lcs[i]
                unit = UNITS[i % len(UNITS)]
                at = int(rng.integers(0, length - w))
                seq[at: at + w] = np.frombuffer((unit * (w // len(unit) + 1))[:w],
                                                np.uint8)
            k = length // 80
            body = np.hstack([seq[: k * 80].reshape(k, 80),
                              np.full((k, 1), ord("\n"), np.uint8)])
            fh.write(b">ctg_%d len=%d\n" % (i, length))
            fh.write(body.tobytes())
            if length % 80:
                fh.write(seq[k * 80:].tobytes() + b"\n")
            seqs.append(seq)
    return {"path": str(path), "seqs": seqs}
