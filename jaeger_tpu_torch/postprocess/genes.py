"""Copy of `jaeger_tpu/postprocess/genes.py`.

Metagenomic gene calling for prophage boundary refinement.

Role parity: the reference calls ``pyrodigal_gv.ViralGeneFinder(meta=True)``
(``postprocess/prophage_boundaries.py:25-48``) solely to obtain gene
intervals for snapping window-grid prophage boundaries to intergenic
positions. This module implements a Prodigal-style caller scoped to that
interface:

* candidate generation per stop-to-stop region with EVERY in-frame start
  codon considered (ATG/GTG/TTG; stops TAA/TAG/TGA), both strands;
* per-candidate scoring: length log-odds (random ORFs hit a stop every
  ~21 codons, so coding length is evidence), start-codon type weights
  (ATG > GTG > TTG, Prodigal's ordering), and a Shine-Dalgarno
  ribosome-binding-site score over the upstream window (AGGAGG sub-motifs
  with spacer-dependent weights — Prodigal's RBS bins, simplified);
* gene selection by dynamic programming over compatible candidates
  (small inter-gene overlaps allowed, as in Prodigal's connection
  scoring), so weak/spurious ORFs drop out and each region gets ONE
  chosen start.

* hexamer (dicodon) coding statistics, self-trained on the contig:
  a first pass selects genes with length/start/RBS evidence alone, the
  in-frame hexamer distribution of those gene interiors vs the contig
  background yields per-position log-odds (stride-3 prefix sums make
  each candidate's coding score O(1)), and a second pass re-selects
  with the coding term added — Prodigal's single-mode self-training
  scoped to one contig;
* genetic-code auto-detection over {11, 4 (TGA=Trp), 15 (TAG
  readthrough)} — pyrodigal-gv's viral-code sweep: each code runs the
  full two-pass caller and the code with the highest total selected
  score wins (code 11 keeps a small prior so noise never flips it).

Remaining divergence vs pyrodigal-gv (documented): statistics are
self-trained per contig rather than pyrodigal's pre-trained metagenomic
profiles; interval-level agreement on coding regions is what the
boundary snapper needs.
"""

from __future__ import annotations

from bisect import bisect_right

import numpy as np

_STOPS = {"TAA", "TAG", "TGA"}
_STARTS = {"ATG", "GTG", "TTG"}
_COMP = str.maketrans("ATGCatgc", "TACGtacg")

#: stop sets per supported genetic code (pyrodigal-gv's viral sweep:
#: 11 standard, 4 TGA->Trp, 15 TAG readthrough)
_CODE_STOPS = {
    11: frozenset({"TAA", "TAG", "TGA"}),
    4: frozenset({"TAA", "TAG"}),
    15: frozenset({"TAA", "TGA"}),
}
#: margins the alternative codes must clear over code 11: removing a stop
#: codon can only lengthen stop-to-stop regions, so permissive codes
#: weakly inflate total scores on standard-code DNA; requiring a relative
#: + absolute win (the hexamer second pass penalizes non-coding
#: readthrough extensions) keeps code 11 unless the evidence is real
_CODE_REL_MARGIN = 1.05
_CODE_ABS_MARGIN = 3.0

# Prodigal-flavoured scoring weights (relative scale is what matters:
# the DP keeps only positive-score genes)
_START_W = {"ATG": 1.0, "GTG": 0.25, "TTG": -0.5}
_LEN_W = 0.30          # per codon beyond the chance baseline
_LEN_BASE = 25         # ~chance ORF length in codons
_MAX_OVERLAP = 60      # nt of allowed overlap between selected genes

#: SD sub-motifs scored in the upstream window, strongest first
_RBS_MOTIFS = (
    ("AGGAGG", 3.0), ("GGAGG", 2.5), ("AGGAG", 2.5), ("AGGA", 1.5),
    ("GGAG", 1.5), ("GAGG", 1.5), ("AGG", 0.8), ("GGA", 0.5),
)


def _rbs_score(seq: str, start: int) -> float:
    """Best SD-motif score in the 5-14 nt spacer window upstream of
    ``start`` (Prodigal's RBS spacer bins, simplified to a triangular
    spacer weight peaking at 5-10 nt)."""
    lo = max(0, start - 20)
    region = seq[lo:start]
    best = 0.0
    for motif, w in _RBS_MOTIFS:
        idx = region.find(motif)
        while idx != -1:
            spacer = start - (lo + idx + len(motif))
            if 3 <= spacer <= 15:
                spacer_w = 1.0 if 5 <= spacer <= 10 else 0.6
                best = max(best, w * spacer_w)
            idx = region.find(motif, idx + 1)
    return best


def _codon_ids(seq: str) -> "np.ndarray":
    """Codon id (base-4, A=0 C=1 G=2 T=3) at every position; -1 where any
    base is ambiguous. Length ``max(len(seq) - 2, 0)``."""
    b = _BASE_IDX[np.frombuffer(seq.encode("ascii"), np.uint8)].astype(
        np.int64
    )
    if b.shape[0] < 3:
        return np.zeros(0, np.int64)
    c = b[:-2] * 16 + b[1:-1] * 4 + b[2:]
    valid = (b[:-2] >= 0) & (b[1:-1] >= 0) & (b[2:] >= 0)
    return np.where(valid, c, -1)


def _cid(codon: str) -> int:
    return int(_BASE_IDX[ord(codon[0])] * 16 + _BASE_IDX[ord(codon[1])] * 4
               + _BASE_IDX[ord(codon[2])])


def _candidates_forward(seq: str, min_len: int, stops=_STOPS, hexp=None,
                        cod=None, hex_capped=False):
    """Scored gene candidates on the forward strand.

    Yields ``(start, end, score)`` with ``end`` at the stop codon's 3'
    side; every in-frame start within a stop-to-stop region produces a
    candidate (Prodigal evaluates all starts, not just the first).
    ``hexp`` is the optional stride-3 hexamer-log-odds prefix structure
    for the coding-statistics term; ``cod`` a precomputed
    :func:`_codon_ids` array. The codon scan is vectorized — the Python
    loop runs only over start/stop events, not every position.
    """
    n = len(seq)
    if cod is None:
        cod = _codon_ids(seq)
    is_stop = np.isin(cod, np.array([_cid(s) for s in stops]))
    is_start = np.isin(cod, np.array([_cid(s) for s in _STARTS]))
    for frame in range(3):
        ev = np.nonzero(is_stop[frame::3] | is_start[frame::3])[0] * 3
        starts: list[int] = []
        for i in (ev + frame).tolist():
            if is_stop[i]:
                end = i + 3
                for s in starts:
                    if end - s >= min_len:
                        yield s, end, _score(seq, s, end, hexp=hexp,
                                             hex_capped=hex_capped)
                starts = []
            else:
                starts.append(i)
        # open region at the contig edge (Prodigal allows runoff genes)
        end = n - (n - frame) % 3
        for s in starts:
            if end - s >= min_len:
                yield s, end, _score(seq, s, end, edge=True, hexp=hexp,
                                     hex_capped=hex_capped)


def _score(seq: str, start: int, end: int, edge: bool = False,
           hexp=None, hex_capped: bool = False) -> float:
    codons = (end - start) // 3
    score = _LEN_W * (codons - _LEN_BASE)
    score += _START_W.get(seq[start : start + 3], -0.5)
    score += _rbs_score(seq, start)
    if edge:
        score -= 0.5
    if hexp is not None:
        hx = _HEX_W * _hex_score(hexp, start, end)
        if hex_capped:
            # pre-trained-prior mode: the coding term is a bounded
            # refinement (at most half the candidate's own length/start/
            # RBS evidence), biasing start choice and overlap competition
            # without ever erasing strong direct evidence on compositions
            # unlike the prior's training genome
            cap = 0.5 * max(score, 0.5)
            hx = float(np.clip(hx, -cap, cap))
        score += hx
    return score


# ---------------------------------------------------------------------------
# hexamer (dicodon) coding statistics — Prodigal-style, self-trained
# ---------------------------------------------------------------------------

_HEX_W = 1.0           # weight of the summed per-gene hexamer log-odds
_HEX_PRIOR = 64.0      # strength of the background-proportional prior
_HEX_EPS = 0.1         # floor pseudocount for empty background bins
_MIN_TRAIN_NT = 1200   # below this much first-pass coding nt, skip stats

_BASE_IDX = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_IDX[_b] = _i


def _hex_ids(seq: str) -> np.ndarray:
    """Hexamer id at every position (−1 where any base is ambiguous)."""
    b = _BASE_IDX[np.frombuffer(seq.encode("ascii"), np.uint8)]
    n = b.shape[0]
    if n < 6:
        return np.full(max(n, 0), -1, np.int64)
    valid = b >= 0
    ids = np.zeros(n - 5, np.int64)
    ok = np.ones(n - 5, bool)
    for j in range(6):
        ids = ids * 4 + np.maximum(b[j : n - 5 + j], 0)
        ok &= valid[j : n - 5 + j]
    out = np.full(n, -1, np.int64)
    out[: n - 5] = np.where(ok, ids, -1)
    return out


def _interior_positions(genes: list[tuple[int, int]]) -> np.ndarray:
    """In-frame interior codon starts (start and stop codons skipped)."""
    chunks = [np.arange(s + 3, e - 8, 3) for s, e in genes]
    chunks = [c for c in chunks if c.size]
    if not chunks:
        return np.zeros(0, np.int64)
    return np.concatenate(chunks)


def _hex_logodds(ids_f: np.ndarray, ids_r: np.ndarray,
                 pos_f: np.ndarray, pos_r: np.ndarray) -> np.ndarray | None:
    """log(P(hex | coding) / P(hex | background)) per hexamer, pooled over
    both strands: coding = in-frame interiors of first-pass genes read in
    their own orientation; background = every valid hexamer."""
    cod = np.concatenate([
        ids_f[pos_f] if pos_f.size else np.zeros(0, np.int64),
        ids_r[pos_r] if pos_r.size else np.zeros(0, np.int64),
    ])
    cod = cod[cod >= 0]
    if cod.size * 3 < _MIN_TRAIN_NT:
        return None
    bg = np.concatenate([ids_f[ids_f >= 0], ids_r[ids_r >= 0]])
    c_cod = np.bincount(cod, minlength=4096).astype(np.float64)
    c_bg = np.bincount(bg, minlength=4096).astype(np.float64)
    p_bg = (c_bg + _HEX_EPS) / (bg.size + 4096 * _HEX_EPS)
    # smooth the (small) coding sample toward the background
    # DISTRIBUTION, not toward uniform: a uniform pseudocount would
    # swamp a few hundred training hexamers and flip the sign of the
    # log-odds (absent hexamers would score positive)
    p_cod = (c_cod + _HEX_PRIOR * p_bg) / (cod.size + _HEX_PRIOR)
    return np.log(p_cod / p_bg)


def _prefix_from_logodds(ids: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Stride-3 prefix sums of per-position hexamer log-odds: ``P[r, k]``
    is the sum of log-odds at positions ``r, r+3, ..., r+3(k-1)``, so a
    candidate's in-frame coding score is one subtraction
    (see :func:`_hex_score`)."""
    per_pos = np.where(ids >= 0, lo[np.maximum(ids, 0)], 0.0)
    n = per_pos.shape[0]
    m = (n + 2) // 3 + 1
    pref = np.zeros((3, m), np.float64)
    for r in range(3):
        vals = per_pos[r::3]
        pref[r, 1 : vals.shape[0] + 1] = np.cumsum(vals)
    return pref


def _hex_score(pref: np.ndarray, start: int, end: int) -> float:
    """Sum of in-frame hexamer log-odds over codon starts in
    ``[start+3, end-9]`` (gene interior, matching the training window)."""
    r = start % 3
    k_lo = (start + 3 - r) // 3
    k_hi = (end - 8 - r) // 3 + 1  # one past the last interior codon
    row = pref[r]
    k_lo = min(max(k_lo, 0), row.shape[0] - 1)
    k_hi = min(max(k_hi, k_lo), row.shape[0] - 1)
    return float(row[k_hi] - row[k_lo])


def _select(cands):
    """Max-weight compatible subset (overlaps <= _MAX_OVERLAP allowed).

    Weighted-interval DP over candidates sorted by end — Prodigal's
    connection-scoring dynamic program restricted to overlap rules.
    Candidates are ``(start, end, score, *tag)``; returns the chosen
    candidates (tags preserved) and the total selected score.
    """
    cands = sorted((c for c in cands if c[2] > 0), key=lambda c: c[1])
    if not cands:
        return [], 0.0
    ends = [c[1] for c in cands]
    # dp[i] = best total using candidates[0..i-1]; keep chosen set via
    # parent pointers
    best = [0.0] * (len(cands) + 1)
    take = [False] * len(cands)
    prev = [0] * len(cands)
    for i, c in enumerate(cands):
        j = bisect_right(ends, c[0] + _MAX_OVERLAP, 0, i)
        prev[i] = j
        with_i = best[j] + c[2]
        if with_i > best[i]:
            best[i + 1] = with_i
            take[i] = True
        else:
            best[i + 1] = best[i]
    out = []
    i = len(cands)
    while i > 0:
        if take[i - 1]:
            out.append(cands[i - 1])
            i = prev[i - 1]
        else:
            i -= 1
    out.reverse()
    return out, best[len(cands)]


_PRIOR_PATH_ENV = "JAEGER_TPU_TORCH_HEXAMER_PRIOR"
_prior_cache: list = []  # [np.ndarray | None] once loaded


def pretrained_hexamer_logodds() -> np.ndarray | None:
    """The shipped pre-trained hexamer coding prior (4096 log-odds).

    Role parity: pyrodigal-gv's meta-mode pre-trained profiles
    (reference ``postprocess/prophage_boundaries.py:25-48``) give short /
    gene-poor contigs coding statistics that per-contig self-training
    cannot. This table is trained OFFLINE by
    ``scripts/build_hexamer_prior.py``: the two-pass caller selects genes
    on the bundled real assembly contigs (30-45 kb, long enough for
    self-training to be reliable), and their pooled interior hexamer
    counts vs background yield the log-odds. Genuine pyrodigal-gv
    profiles are not reproducible in-image (the package is not
    installed and there is no network); the divergence stays documented.
    """
    if not _prior_cache:
        import os
        from pathlib import Path

        path = Path(os.environ.get(
            _PRIOR_PATH_ENV,
            # the JAX package's shipped table, read as data
            Path(__file__).resolve().parents[2] / "jaeger_tpu" / "data"
            / "hexamer_prior.npz",
        ))
        if path.exists():
            with np.load(path) as z:
                _prior_cache.append(z["logodds"].astype(np.float64))
        else:
            _prior_cache.append(None)
    return _prior_cache[0]


def _gather(seq: str, rc: str, n: int, min_len: int, stops,
            cod_f, cod_r, hexp_f=None, hexp_r=None, hex_capped=False):
    """Both-strand candidates in genome coordinates, tagged with strand
    (+1 forward / -1 reverse)."""
    cands = [
        (s, e, w, 1)
        for s, e, w in _candidates_forward(seq, min_len, stops, hexp_f,
                                           cod_f, hex_capped)
    ]
    cands += [
        (n - e, n - s, w, -1)
        for s, e, w in _candidates_forward(rc, min_len, stops, hexp_r,
                                           cod_r, hex_capped)
    ]
    return cands


def _call_code(seq: str, rc: str, n: int, min_len: int, stops,
               cod_f, cod_r, ids_f, ids_r, prior_lo=None):
    """Two-pass caller for one genetic code: pass 1 selects on
    length/start/RBS alone (no coding prior — mirroring Prodigal's
    initial training selection), self-trains hexamer statistics on that
    selection, and pass 2 re-selects with the self-trained coding term.
    Gene-poor/short contigs whose pass-1 selection cannot support
    self-training fall back to a pass 2 scored with the SHIPPED
    pre-trained prior — recentered on this contig's background and
    capped per candidate — the pyrodigal-gv meta-mode role.
    Returns (intervals, total_selected_score)."""
    first, total = _select(
        _gather(seq, rc, n, min_len, stops, cod_f, cod_r)
    )
    fwd = [(c[0], c[1]) for c in first if c[3] == 1]
    rev = [(n - c[1], n - c[0]) for c in first if c[3] == -1]  # rc coords
    lo = _hex_logodds(ids_f, ids_r,
                      _interior_positions(fwd), _interior_positions(rev))
    capped = False
    if lo is None and prior_lo is not None:
        # meta-mode fallback: recenter the pre-trained log-odds on THIS
        # contig's valid hexamers so the prior scores relative coding
        # enrichment (~zero-mean on compositions unlike its training
        # genome — cf. Prodigal meta-mode's bank of GC-binned profiles);
        # the per-candidate cap in _score bounds its influence
        both = np.concatenate([ids_f[ids_f >= 0], ids_r[ids_r >= 0]])
        lo = prior_lo - (
            float(prior_lo[both].mean()) if both.size else 0.0
        )
        capped = True
    if lo is None:
        return [(c[0], c[1]) for c in first], total
    hexp_f = _prefix_from_logodds(ids_f, lo)
    hexp_r = _prefix_from_logodds(ids_r, lo)
    second, total = _select(
        _gather(seq, rc, n, min_len, stops, cod_f, cod_r, hexp_f, hexp_r,
                hex_capped=capped)
    )
    return [(c[0], c[1]) for c in second], total


def find_genes(sequence: str, min_len: int = 90, mode: str = "scored",
               genetic_code: int | None = None) -> list[tuple[int, int]]:
    """0-based half-open gene intervals on both strands, sorted.

    ``mode='scored'`` (default) runs the Prodigal-style two-pass caller
    (start selection + self-trained hexamer statistics + DP);
    ``mode='orf'`` returns the round-1 maximal-ORF superset.
    ``genetic_code``: 11, 4, or 15 to pin a code; ``None`` sweeps all
    three (pyrodigal-gv behavior) and keeps code 11 unless an
    alternative clears the relative + absolute evidence margin.
    """
    seq = sequence.upper()
    n = len(seq)
    rc = seq.translate(_COMP)[::-1]
    if mode == "orf":
        intervals = [
            (s, e) for s, e, _ in _candidates_forward(seq, min_len)
        ]
        intervals += [
            (n - e, n - s) for s, e, _ in _candidates_forward(rc, min_len)
        ]
        intervals.sort()
        return _merge_same_stop(intervals)
    if genetic_code is not None:
        if genetic_code not in _CODE_STOPS:
            raise ValueError(
                f"unsupported genetic code {genetic_code} "
                f"(supported: {sorted(_CODE_STOPS)})"
            )
        codes = [genetic_code]
    else:
        codes = sorted(_CODE_STOPS)
    cod_f, cod_r = _codon_ids(seq), _codon_ids(rc)
    ids_f, ids_r = _hex_ids(seq), _hex_ids(rc)
    prior_lo = pretrained_hexamer_logodds()
    results = {
        code: _call_code(seq, rc, n, min_len, _CODE_STOPS[code],
                         cod_f, cod_r, ids_f, ids_r, prior_lo=prior_lo)
        for code in codes
    }
    if len(results) == 1:
        best_genes = next(iter(results.values()))[0]
    else:
        best_genes, best_total = results[11]
        floor = _CODE_REL_MARGIN * best_total + _CODE_ABS_MARGIN
        for code in (4, 15):
            genes, total = results[code]
            if total > floor and total > best_total:
                best_genes, best_total = genes, total
    best_genes.sort()
    return best_genes


def _merge_same_stop(intervals: list[tuple[int, int]]):
    """Keep the longest ORF per stop (round-1 behavior for mode='orf')."""
    by_end: dict[int, tuple[int, int]] = {}
    for s, e in intervals:
        cur = by_end.get(e)
        if cur is None or s < cur[0]:
            by_end[e] = (s, e)
    return sorted(by_end.values())


def _is_intergenic(position: int, genes: list[tuple[int, int]]) -> bool:
    for start, end in genes:
        if start <= position < end:
            return False
        if start > position:
            break
    return True


def refine_boundary(position: int, genes: list[tuple[int, int]], side: str,
                    max_extension: int | None = None) -> int:
    """Snap one boundary outward to the nearest intergenic position.

    Parity: reference ``prophage_boundaries.py:63-123`` — left boundaries
    move to the containing gene's start, right boundaries to its end,
    capped at ``max_extension``.
    """
    if side not in {"left", "right"}:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if _is_intergenic(position, genes):
        return position
    containing = next(
        ((s, e) for s, e in genes if s <= position < e), None
    )
    if containing is None:
        return position
    gene_start, gene_end = containing
    refined = gene_start if side == "left" else gene_end
    if max_extension is not None and abs(refined - position) > max_extension:
        refined = (
            position + max_extension if side == "right"
            else position - max_extension
        )
    return refined


def refine_region(raw_start: int, raw_end: int, genes, max_extension=None):
    return (
        refine_boundary(raw_start, genes, "left", max_extension),
        refine_boundary(raw_end, genes, "right", max_extension),
    )


def refine_prophage_boundaries(
    prophage_cordinates: dict,
    fasta_path,
    fsize: int,
    max_extension: int | None = None,
    stride: int | None = None,
) -> dict[str, list[tuple[int, int, int, int]]]:
    """Per-contig (raw_start, raw_end, refined_start, refined_end) tuples.

    Parity: reference ``prophage_boundaries.py:138-193`` — raw region =
    [first-window start, last-window end], default cap ``2*fsize``.
    """
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    if max_extension is None:
        max_extension = 2 * fsize
    step = stride or fsize
    refined: dict[str, list[tuple[int, int, int, int]]] = {}
    for header, sequence in read_fasta(str(fasta_path)):
        header = header.strip().replace(",", "___")
        if header not in prophage_cordinates:
            continue
        cords, _ = prophage_cordinates[header]
        if len(cords) == 0:
            refined[header] = []
            continue
        genes = find_genes(sequence)
        contig_refined = []
        for start_idx, end_idx in cords:
            raw_start = int(start_idx * step)
            raw_end = int((end_idx - 1) * step + fsize)
            rs, re_ = refine_region(raw_start, raw_end, genes, max_extension)
            contig_refined.append(
                (raw_start, raw_end, max(rs, 0), min(re_, len(sequence)))
            )
        refined[header] = contig_refined
    return refined
