"""Copy of `jaeger_tpu/seqops/maps.py`.

Codon maps and reduced-alphabet translation tables.

Parity target: ``src/jaeger/seqops/maps.py`` in the reference. The reference
lists 64 codons in genetic-code-table order (middle base slowest: TCAG for
the second position, then TCAG for the first, then TCAG for the third) and
assigns integer IDs by list position; reduced alphabets (amino acid, PC2,
Murphy-10, PC5) then remap those IDs. Here everything is derived
programmatically from the standard genetic code rather than hand-listed.
"""

from __future__ import annotations

from itertools import product

_TCAG = "TCAG"

#: 64 codons in classical codon-table order (second base varies slowest,
#: third base fastest) — the ID order every model checkpoint depends on.
#: Matches reference ``seqops/maps.py:3-68`` (CODONS).
CODONS: list[str] = [b1 + b2 + b3 for b2 in _TCAG for b1 in _TCAG for b3 in _TCAG]

#: Identity codon IDs (0..63). Reference ``seqops/maps.py:542``.
CODON_ID: list[int] = list(range(len(CODONS)))

_CODON_TABLE = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}
#: Standard genetic code, indexed by codon string ('*' = stop).
GENETIC_CODE: dict[str, str] = dict(_CODON_TABLE)

#: Amino-acid letters in first-appearance order over CODONS, '*' included.
_AA_ORDER: list[str] = []
for _c in CODONS:
    _a = GENETIC_CODE[_c]
    if _a not in _AA_ORDER:
        _AA_ORDER.append(_a)

#: Amino-acid translation of each codon (list parallel to CODONS).
AA: list[str] = [GENETIC_CODE[c] for c in CODONS]

# Every reduced alphabet below follows the reference's shared numbering
# convention (its TF lookup tables default unknown codons to 0): stop
# codons map to class 0 and the amino groups take 1..N in codon-table
# first-encounter order (or a fixed group order where noted). Each list
# is pinned value-identical to the reference's literal tables against
# the LIVE reference package (tests/test_encode_live_parity.py).

#: Codon ID -> amino-acid class ID (reference ``seqops/maps.py:137``):
#: stop = 0, the 20 amino acids = 1..20 in first-encounter order.
_AA_MODERN_ORDER: list[str] = [a for a in _AA_ORDER if a != "*"]
AA_ID: list[int] = [
    0 if a == "*" else _AA_MODERN_ORDER.index(a) + 1 for a in AA
]

#: Legacy v1 numbering (``preprocess/v1/maps.py`` TRIMER_INT equals this
#: + the encoder's +1 token shift): plain first-encounter order with '*'
#: keeping its own slot. Used only by the legacy ``default`` WRes path.
AA_V1_ID: list[int] = [_AA_ORDER.index(a) for a in AA]

# --- Reduced alphabets -------------------------------------------------------
# Murphy-10: standard 10-letter reduction of the amino-acid alphabet
# (Murphy, Wallqvist & Levy 2000): LVIMC, ASGTP(-> here A,S,G,T,P grouped per
# the published table), FYW, EDNQ, KR, H.
_MURPHY10_GROUPS = {
    "L": "L", "V": "L", "I": "L", "M": "L", "C": "C",
    "A": "A", "G": "G", "S": "S", "T": "S", "P": "P",
    "F": "F", "Y": "F", "W": "F",
    "E": "E", "D": "E", "N": "E", "Q": "E",
    "K": "K", "R": "K", "H": "H", "*": "*",
}
_M10_ORDER: list[str] = []
for _c in CODONS:
    _g = _MURPHY10_GROUPS[GENETIC_CODE[_c]]
    if _g != "*" and _g not in _M10_ORDER:
        _M10_ORDER.append(_g)
#: Codon ID -> Murphy-10 class ID (stop/unknown = 0, groups 1..10).
#: Reference ``seqops/maps.py:408`` and ``preprocess/v2/maps.py``
#: MURPHY10_INT are the same list.
MURPHY10_ID: list[int] = [
    0 if _MURPHY10_GROUPS[a] == "*"
    else _M10_ORDER.index(_MURPHY10_GROUPS[a]) + 1
    for a in AA
]
#: The legacy v2 preprocessor's name for the same numbering.
MURPHY10_V2_ID: list[int] = list(MURPHY10_ID)

# PC5: the reference's five physicochemical classes in its fixed group
# order (``seqops/maps.py:475``): aromatic+H, aliphatic, polar-neutral,
# small, charged.
_PC5_GROUPS_ORDERED: list[str] = ["FHWY", "ILV", "MNPQT", "ACGS", "DEKR"]
#: Codon ID -> PC5 class ID (stop = 0, groups 1..5).
PC5_ID: list[int] = [
    0 if a == "*"
    else 1 + next(i for i, g in enumerate(_PC5_GROUPS_ORDERED) if a in g)
    for a in AA
]

# PC2: the reference's two-class split (``seqops/maps.py:227``) —
# hydrophobic/neutral (incl. S, T, Y) vs charged/polar.
_PC2_GROUPS_ORDERED: list[str] = ["ACFGILMPSTVWY", "DEHKNQR"]
#: Codon ID -> PC2 class ID (stop = 0, groups 1..2).
PC2_ID: list[int] = [
    0 if a == "*"
    else 1 + next(i for i, g in enumerate(_PC2_GROUPS_ORDERED) if a in g)
    for a in AA
]

#: Codon ID -> synonymous-codon ordinal within its amino family, 1-based,
#: counted in codon-table order (reference ``seqops/maps.py:341`` COD_ID).
#: TGA is counted in the W family — the reference table follows the
#: TGA->Trp recoding convention — so TAA/TAG are 1/2 and TGA/TGG are 1/2.
_COD_COUNTS: dict[str, int] = {}
COD_ID: list[int] = []
for _c in CODONS:
    _f = "W" if _c == "TGA" else GENETIC_CODE[_c]
    _COD_COUNTS[_f] = _COD_COUNTS.get(_f, 0) + 1
    COD_ID.append(_COD_COUNTS[_f])

#: Dicodons (4096) and their IDs. Reference ``seqops/maps.py:544-546``.
DICODONS: list[str] = ["".join(p) for p in product(CODONS, CODONS)]
DICODON_ID: list[int] = list(range(len(DICODONS)))

#: Named registry used by YAML configs (``codon:``/``codon_id:`` fields).
ALPHABETS: dict[str, tuple[list[str], list[int]]] = {
    "CODON": (CODONS, CODON_ID),
    "CODON_ID": (CODONS, CODON_ID),
    "COD": (CODONS, COD_ID),
    "AA": (CODONS, AA_ID),
    "AA_ID": (CODONS, AA_ID),
    "AA_V1": (CODONS, AA_V1_ID),
    "MURPHY10": (CODONS, MURPHY10_ID),
    "MURPHY10_ID": (CODONS, MURPHY10_ID),
    "MURPHY10_V2": (CODONS, MURPHY10_V2_ID),
    "PC5": (CODONS, PC5_ID),
    "PC5_ID": (CODONS, PC5_ID),
    "PC2": (CODONS, PC2_ID),
    "PC2_ID": (CODONS, PC2_ID),
    "DICODON": (DICODONS, DICODON_ID),
    "DICODON_ID": (DICODONS, DICODON_ID),
}


def resolve_alphabet(name: str | None) -> tuple[list[str], list[int]]:
    """Resolve a config alphabet name to ``(codons, codon_ids)``."""
    if name is None:
        return CODONS, CODON_ID
    key = str(name).upper()
    if key not in ALPHABETS:
        raise ValueError(f"unknown codon alphabet {name!r}")
    return ALPHABETS[key]


def alphabet_depth(codon_ids: list[int]) -> int:
    """Number of distinct classes in a codon-ID mapping (one-hot depth)."""
    return max(codon_ids) + 1
