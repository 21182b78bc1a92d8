"""blastn-mode nucleotide search (mmseqs `search --search-type 3`).

Full pipeline parity with the reference's blastn.sh workflow
(Search.cpp:32-175 mode matrix; see search_nucl's docstring for the
stage list). m8 output is byte-identical to the reference binary's
`search --search-type 3` + `convertalis` on pinned fixtures
(tests/test_searchnucl_parity.py) covering both strands, duplicated
targets with saturated diagonals, N runs, and 10 kb split boundaries.

Output: BLAST tab (m8) rows
  query target pident alnlen mismatch gapopen qstart qend tstart tend
  evalue bits        (1-based inclusive; minus-strand hits carry
                      qstart > qend with ascending target coordinates)
"""
from dataclasses import dataclass

import numpy as np

from ..alphabet import encode_nucl, revcomp_ascii
from ..ops.banded_nucl import banded_align_batch, banded_nucleotide_align
from ..ops.evalue import EvalueComputer, gumbel_params
from ..ops.matrices import load_matrix


@dataclass
class NuclHit:
    query: str
    target: str
    pident: float
    alnlen: int
    mismatch: int
    gapopen: int
    q_start: int     # 1-based inclusive, forward-strand coords
    q_end: int
    t_start: int     # t_start > t_end on minus-strand hits
    t_end: int
    evalue: float
    bits: float
    raw_score: int = 0

    def m8_row(self) -> str:
        ev = f"{self.evalue:.3E}"
        return (f"{self.query}\t{self.target}\t{self.pident:.3f}\t"
                f"{self.alnlen}\t{self.mismatch}\t{self.gapopen}\t"
                f"{self.q_start}\t{self.q_end}\t{self.t_start}\t"
                f"{self.t_end}\t{ev}\t{int(round(self.bits))}")


MAX_SEQ_LEN = 10000      # blastn.sh splitsequence operating point


def _split_chunks(length: int, max_len: int = MAX_SEQ_LEN):
    """splitsequence (mode 1, overlap 0): [(start, len)] chunks."""
    import math
    n = max(1, math.ceil(length / max_len))
    return [(s * max_len, min(max_len, length - s * max_len))
            for s in range(n)]


def search_nucl(q_entries, t_entries, k: int = 15, evalue: float = 1e-3,
                gap_open: int = 5, gap_extend: int = 2, zdrop: int = 40,
                max_seqs: int = 300, strand: int = 2,
                min_ungapped_score: int = 15, index=None):
    """q_entries/t_entries: [(name, ascii uint8 array)].
    strand: 0 = minus only, 1 = plus only, 2 = both.
    Returns {query_name: [NuclHit] in the reference's merged order}.

    Full blastn.sh pipeline parity (mmseqs `search --search-type 3`):
    splitsequence on both sides (10 kb hard chunks) -> extractframes on
    queries (fwd + revcomp) -> nucleotide prefilter (exact spaced
    15-mers, tantan-masked targets, diagonal rescore,
    min-ungapped-score gate, max-seqs histogram;
    ops/nucl_prefilter.py) -> BandedNucleotideAligner gapped alignment
    (probe-parity engine, ops/banded_nucl.py) -> offsetalignment
    coordinate mapping + merge-query + Matcher::compareHits sort ->
    convertalis m8 fields. m8 rows are byte-identical to the reference
    binary's output on pinned fixtures (tests/test_searchnucl_parity.py)
    up to createdb's key shuffle on duplicate targets."""
    from ..ops.align import format_seq_id
    from ..ops.nucl_prefilter import (SPACED_SEED_15, build_nucl_ref_index,
                                      mask_nucl_targets,
                                      nucl_prefilter_query)

    matrix = load_matrix("nucleotide.out", 1.0)
    mat = matrix.scores
    if k == 15:
        pattern = SPACED_SEED_15
    else:
        pattern = np.ones(k, dtype=np.int64)

    # --- splitsequence on targets: chunks keep their parent key ---
    t_chunks = []          # (parent_ti, from0, num)
    for ti, (_, seq) in enumerate(t_entries):
        num = encode_nucl(np.asarray(seq, dtype=np.uint8))
        for start, ln in _split_chunks(len(num)):
            t_chunks.append((ti, start, num[start:start + ln]))
    t_masked = mask_nucl_targets([c[2] for c in t_chunks], matrix)
    idx = build_nucl_ref_index(t_masked, pattern)
    t_res = int(sum(len(c[2]) for c in t_chunks))
    evaluer = EvalueComputer(
        gumbel_params("nucleotide.out", gap_open, gap_extend), t_res)
    t_lens = [len(seq) for _, seq in t_entries]

    # ---- stage 1: prefilter every (query, strand, chunk) and stage
    # the candidate pairs flat (batched-driver pattern: no per-pair
    # Python dispatch in the alignment stage)
    strands = {0: ("-",), 1: ("+",), 2: ("+", "-")}[strand]
    q_chunks = []        # encoded frame chunks (alignment queries)
    cands = []           # (qei, sgn, c_from, chunk_idx, t, diag)
    for qei, (qname, q_ascii) in enumerate(q_entries):
        q_ascii = np.asarray(q_ascii, dtype=np.uint8)
        L = len(q_ascii)
        for sgn in strands:
            # extractframes: '-' = revcomp with origin at L-1
            frame = (encode_nucl(q_ascii) if sgn == "+"
                     else encode_nucl(revcomp_ascii(q_ascii)))
            for start, ln in _split_chunks(len(frame)):
                chunk = frame[start:start + ln]
                ci = len(q_chunks)
                q_chunks.append(chunk)
                # chunk origin on the ORIGINAL strand (splitsequence
                # header rewrite, splitsequence.cpp:97-116)
                c_from = start if sgn == "+" else (L - 1) - start
                for t, _sc, diag in nucl_prefilter_query(
                        chunk, idx, matrix, pattern, max_seqs,
                        min_ungapped_score):
                    cands.append((qei, sgn, c_from, ci, t, diag))

    # ---- stage 2: ONE native alignment walk over all candidates
    # (banded_align_batch; bit-identical per-pair fallback otherwise)
    batch = banded_align_batch(
        q_chunks, [c[2] for c in t_chunks],
        [(c[3], c[4], c[5] & 0xFFFF) for c in cands],
        mat, gap_open, gap_extend, zdrop) if cands else None

    # ---- stage 3: vectorized E-values + m8 assembly
    out = {qname: [] for qname, _ in q_entries}
    if not cands:
        return out
    if batch is not None:
        b_score, b_qs, b_qe, b_ts, b_te, b_ids, b_btlen = batch
    else:
        n = len(cands)
        b_score = np.empty(n, np.int32)
        b_qs = np.empty(n, np.int32)
        b_qe = np.empty(n, np.int32)
        b_ts = np.empty(n, np.int32)
        b_te = np.empty(n, np.int32)
        b_ids = np.empty(n, np.int32)
        b_btlen = np.empty(n, np.int32)
        for i, (qei, sgn, c_from, ci, t, diag) in enumerate(cands):
            r = banded_nucleotide_align(
                q_chunks[ci], t_chunks[t][2], diag & 0xFFFF, mat,
                gap_open, gap_extend, zdrop)
            b_score[i] = r.score
            b_qs[i] = r.q_start
            b_qe[i] = r.q_end
            b_ts[i] = r.t_start
            b_te[i] = r.t_end
            b_ids[i] = r.aa_ids
            b_btlen[i] = len(r.backtrace)
    chunk_lens = np.array([len(q_chunks[c[3]]) for c in cands],
                          dtype=np.int64)
    evs = evaluer.evalue(b_score.astype(np.int64), chunk_lens)
    bits = np.floor(evaluer.bit_score(b_score.astype(np.int64))
                    + 0.5).astype(np.int64)
    keep = evs <= evalue
    rows_by_q = [[] for _ in q_entries]
    for i in np.flatnonzero(keep):
        qei, sgn, c_from, ci, t, diag = cands[i]
        seq_id = (b_ids[i] / b_btlen[i]) if b_btlen[i] else 0.0
        # round-trip through the alignment row text, like
        # offsetalignment's readAlignmentResults
        sid = float(format_seq_id(float(np.float32(seq_id))))
        ev = float(f"{evs[i]:.3E}")
        bit = int(bits[i])
        # updateOffset (offsetalignment.cpp:90-160)
        if sgn == "+":
            qs, qe = c_from + int(b_qs[i]), c_from + int(b_qe[i])
        else:
            qs, qe = c_from - int(b_qs[i]), c_from - int(b_qe[i])
        t_parent, t_from, _ = t_chunks[t]
        ts_, te_ = t_from + int(b_ts[i]), t_from + int(b_te[i])
        alnlen = max(abs(qe - qs), abs(te_ - ts_)) + 1
        bme = np.float32(min(abs(qe - qs), abs(te_ - ts_)))
        mism = int(bme * (np.float32(1.0) - np.float32(sid))
                   + np.float32(0.5))
        rows_by_q[qei].append((ev, -bit, t_lens[t_parent], t_parent,
                               sid, alnlen, mism, qs, qe, ts_, te_,
                               bit))
    for qei, (qname, _) in enumerate(q_entries):
        rows = rows_by_q[qei]
        # merge-query: stable sort by Matcher::compareHits
        rows.sort(key=lambda x: x[:4])
        hits = []
        for (ev, nbit, tlen, tp, sid, alnlen, mism, qs, qe, ts_, te_,
             bit) in rows:
            hits.append(NuclHit(
                query=qname, target=t_entries[tp][0],
                pident=sid, alnlen=alnlen, mismatch=mism, gapopen=0,
                q_start=qs + 1, q_end=qe + 1, t_start=ts_ + 1,
                t_end=te_ + 1, evalue=ev, bits=bit))
        out[qname] = hits
    return out
