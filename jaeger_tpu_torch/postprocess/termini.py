"""Copy of `jaeger_tpu/postprocess/termini.py`.

Terminal repeat (DTR/ITR/LTR) detection.

Parity target: reference ``utils/termini.py:17-189`` — Smith-Waterman of
the contig's first ``scan_length`` bases against its last ``scan_length``
(DTR) and their reverse complement (ITR), with match=2 / mismatch=-100 /
open=100 / extend=5, ``scan_length = clamp(4% len, 400, 4000)``; repeats
longer than 12 are reported, DTRs >= 250 bp promoted to LTR.
Uses the in-repo SW (:mod:`jaeger_tpu_torch.postprocess.sw`) instead of parasail.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from jaeger_tpu_torch.postprocess.sw import SWResult, smith_waterman
from jaeger_tpu_torch.seqops.fasta import read_fasta

_COMP = str.maketrans("ATGCatgc", "TACGtacg")

_EMPTY = {
    "repeat_length": None, "identities": None, "identity": None,
    "score": None, "terminal_repeats": None, "fgaps": None, "rgaps": None,
    "sstart": None, "send": None, "estart": None, "eend": None,
    "front": None, "rear": None,
}


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


def _summary(result: SWResult, seq_len: int, record_id: str,
             input_length: int, type_: str) -> dict:
    alig_len = result.length
    f_gaps = result.query_aligned.count("-")
    rc_gaps = result.ref_aligned.count("-")
    iden = result.comp.count("|")
    ltr_cutoff = 250

    s_alig_start = (result.end_query - alig_len + f_gaps) + 1
    s_alig_end = result.end_query + 1

    if type_ == "ITR":
        e_alig_start = (seq_len - input_length) + max(
            input_length - result.end_ref, 0
        )
        e_alig_end = e_alig_start + (alig_len - rc_gaps)
        rear = reverse_complement(result.ref_aligned)
    else:  # DTR
        e_alig_start = (seq_len - input_length) + max(
            result.end_ref - alig_len, 0
        )
        e_alig_end = (seq_len - input_length) + result.end_ref
        if (s_alig_end - s_alig_start) >= ltr_cutoff:
            type_ = f"LTR_{type_}"
        rear = result.ref_aligned

    return {
        "contig_id": record_id,
        "repeat_length": alig_len,
        "identities": iden,
        "identity": iden / alig_len if alig_len else 0.0,
        "score": result.score,
        "terminal_repeats": type_,
        "fgaps": f_gaps,
        "rgaps": rc_gaps,
        "sstart": s_alig_start,
        "send": s_alig_end,
        "estart": e_alig_start,
        "eend": e_alig_end,
        "seq_len": seq_len,
        "front": result.query_aligned,
        "rear": rear,
    }


def scan_contig(header: str, seq: str) -> dict:
    seq_len = len(seq)
    record_id = header.replace(",", "___")
    scan_length = min(max(int(seq_len * 0.04), 400), 4000)
    front = seq[:scan_length]
    back = seq[-scan_length:]

    result_itr = smith_waterman(front, reverse_complement(back))
    result_dtr = smith_waterman(front, back)

    if result_itr.length > 12 or result_dtr.length > 12:
        if result_itr.score > result_dtr.score:
            return _summary(result_itr, seq_len, record_id, scan_length, "ITR")
        return _summary(result_dtr, seq_len, record_id, scan_length, "DTR")
    return {"contig_id": record_id, "seq_len": seq_len, **_EMPTY}


def scan_for_terminal_repeats(file_path: str, fsize: int = 2000,
                              workers: int = 4) -> pd.DataFrame:
    """Threaded scan over all contigs with length >= ``fsize``."""
    import pandas as pd

    records = [
        (h, s) for h, s in read_fasta(file_path) if len(s) >= fsize
    ]
    if not records:
        return pd.DataFrame(
            columns=["contig_id", "seq_len", *(_EMPTY.keys())]
        )
    with ThreadPoolExecutor(max_workers=workers) as ex:
        summaries = list(ex.map(lambda r: scan_contig(*r), records))
    return pd.DataFrame(summaries)
