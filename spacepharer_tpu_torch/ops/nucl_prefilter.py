"""Nucleotide prefilter (mmseqs `prefilter` on DBTYPE_NUCLEOTIDES).

Parity targets (the blastn.sh operating point: k=15 spaced, exact k-mer
matching, kmerThr=0, diag scoring, min-ungapped-score 15, max-seqs 300,
tantan masking, NucleotideMatrix @ bitFactor 1.0, no bias correction):

  Prefiltering.cpp:170-200, 500-540   takeOnlyBestKmer / kmerThr=0 /
                                      alphabet 4 index / masked lookup
  Sequence.h:41                       spaced_seed_15 pattern (span 23)
  IndexBuilder.cpp                    tantan masking + exact k-mer fill
  QueryMatcher.cpp:84-175             match -> processQuery -> radix ->
                                      nucleotide saturated re-score ->
                                      keepMaxScoreElementOnly ->
                                      threshold -> getResult (incl. the
                                      rescoreHits rescale escape)
  CacheFriendlyOperations.cpp         findDuplicates (shared with the
                                      aa path) + keepMaxElement
  UngappedAlignment.cpp:295-331       profile bias = |min(matrix)|,
                                      u8 cap = 255 - bias
"""
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .prefilter import _bin_bits
from .tantan import likelihood_ratios, mask_sequences_batch

# Sequence.h:41 — the k=15 spaced seed (span 23, weight 15)
SPACED_SEED_15 = np.array(
    [1, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1],
    dtype=np.int64)

NUCL_N = 4          # ambiguous base index in the 5-letter alphabet


@dataclass
class NuclRefIndex:
    seqs_masked: list            # numeric targets, tantan-masked
    uniq_codes: np.ndarray       # int64 sorted unique k-mer codes
    uniq_start: np.ndarray       # int64 [U+1]
    post_seq: np.ndarray         # int32
    post_pos: np.ndarray         # uint16 (first position per (code, t))
    n_targets: int


def _spaced_codes_nucl(num: np.ndarray, pattern: np.ndarray):
    """codes[i] over the informative pattern positions (4 letters);
    invalid where any informative letter is N."""
    offs = np.flatnonzero(pattern)
    span = len(pattern)
    n = len(num) - span + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    num = np.asarray(num, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)
    valid = np.ones(n, dtype=bool)
    for off in offs:
        col = num[off:off + n]
        codes = codes * 4 + np.where(col < 4, col, 0)
        valid &= col < 4
    return codes, valid


def mask_nucl_targets(t_nums, matrix) -> list:
    """tantan masking with the nucleotide matrix's likelihood ratios
    (IndexBuilder masking for DBTYPE_NUCLEOTIDES); masked letter = N."""
    ratios = likelihood_ratios(matrix)
    return mask_sequences_batch(
        [np.asarray(t, dtype=np.int64) for t in t_nums], ratios, NUCL_N,
        bucket_size=2048)


def build_nucl_ref_index(t_masked, pattern=SPACED_SEED_15) -> NuclRefIndex:
    """Exact k-mer postings over the masked targets (IndexTable fill at
    kmerThr=0: every valid window enters; first position per
    (code, target))."""
    parts = []
    for ti, t in enumerate(t_masked):
        codes, valid = _spaced_codes_nucl(t, pattern)
        pos = np.flatnonzero(valid)
        if len(pos) == 0:
            continue
        parts.append((codes[pos], np.full(len(pos), ti, np.int64),
                      pos.astype(np.int64)))
    if parts:
        codes = np.concatenate([p[0] for p in parts])
        tid = np.concatenate([p[1] for p in parts])
        pos = np.concatenate([p[2] for p in parts])
        # (code, tid) first occurrence, sorted by (code, tid)
        order = np.lexsort((tid, codes))
        codes, tid, pos = codes[order], tid[order], pos[order]
        first = np.concatenate(
            ([True], (codes[1:] != codes[:-1]) | (tid[1:] != tid[:-1])))
        codes, tid, pos = codes[first], tid[first], pos[first]
        ustart = np.flatnonzero(
            np.concatenate(([True], codes[1:] != codes[:-1])))
        uniq_codes = codes[ustart]
        uniq_start = np.concatenate([ustart, [len(codes)]]).astype(np.int64)
    else:
        tid = np.zeros(0, np.int64)
        pos = np.zeros(0, np.int64)
        uniq_codes = np.zeros(0, np.int64)
        uniq_start = np.zeros(1, np.int64)
    return NuclRefIndex(
        seqs_masked=list(t_masked), uniq_codes=uniq_codes,
        uniq_start=uniq_start, post_seq=tid.astype(np.int32),
        post_pos=pos.astype(np.uint16), n_targets=len(t_masked))


def _diag_score_exact(profile, tseq, d_u16):
    """Exact int max-subarray along the diagonal (UngappedAlignment::
    computeSingelSequenceScores semantics; bias cancels)."""
    from .prefilter import ungapped_diagonal_score
    d = d_u16 - 65536 if d_u16 >= 32768 else d_u16
    return ungapped_diagonal_score(profile, tseq, d)


def nucl_prefilter_query(q_num, index: NuclRefIndex, matrix,
                         pattern=SPACED_SEED_15, max_seqs: int = 300,
                         min_diag_score: int = 15) -> list:
    """One query entry -> [(target, score, signed diagonal)] rows,
    replicating QueryMatcher::matchQuery for the nucleotide
    configuration. `matrix` is the NucleotideMatrix at bitFactor 1.0."""
    q_num = np.asarray(q_num, dtype=np.int64)
    codes, valid = _spaced_codes_nucl(q_num, pattern)
    n_codes = len(codes)
    if n_codes == 0 or len(index.uniq_codes) == 0:
        return []
    # the final k-mer position's matches are dropped (same upper bound
    # as the aa path, QueryMatcher.cpp:289-293)
    valid = valid.copy()
    valid[n_codes - 1] = False
    kpos = np.flatnonzero(valid)
    if len(kpos) == 0:
        return []

    # exact-match stream: one postings run per present query k-mer
    kcodes = codes[kpos]
    ci = np.searchsorted(index.uniq_codes, kcodes)
    ok = ci < len(index.uniq_codes)
    ci = np.where(ok, ci, 0)
    ok &= index.uniq_codes[ci] == kcodes
    kp = kpos[ok]
    ci = ci[ok]
    if len(ci) == 0:
        return []
    lo = index.uniq_start[ci]
    cnt = (index.uniq_start[ci + 1] - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return []
    base = np.repeat(lo, cnt)
    within = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(cnt)[:-1])), cnt)
    pidx = base + within
    m_t = index.post_seq[pidx].astype(np.int64)
    m_d = (np.repeat(kp, cnt) - index.post_pos[pidx].astype(np.int64)) \
        & 0xFFFF

    # profile + u8 cap (createProfile: bias = |min matrix|, no aaCorr)
    profile = matrix.scores[q_num].astype(np.int64)
    qbias = abs(int(matrix.scores.min()))
    cap = 255 - qbias

    return _nucl_finalize(m_t, m_d, index, profile, cap, q_num,
                          max_seqs, min_diag_score)


def _nucl_finalize(m_t, m_d, index, profile, cap, q_num,
                   max_seqs, min_diag_score):
    """The diagonalScoring + isNucleotide tail of matchQuery
    (QueryMatcher.cpp:103-163)."""
    n_targets = index.n_targets
    bin_bits = _bin_bits(n_targets)
    bin_mask = (1 << bin_bits) - 1

    # --- match(): double-diagonal duplicate filter (shared with aa) ---
    d_u8 = (m_d & 0xFF).astype(np.int64)
    slots = {}
    emit = []                      # (t, d16) in stage-C emission order
    for b in range(bin_mask + 1):
        sel = (m_t & bin_mask) == b
        kept = []
        for t, d16, d8 in zip(m_t[sel], m_d[sel], d_u8[sel]):
            slot = int(t) >> bin_bits
            if slots.get(slot, 0) == d8:
                kept.append((int(t), int(d16), int(d8)))
            slots[slot] = int(d8)
        for t, d16, d8 in reversed(kept):
            slots[t >> bin_bits] = (d8 + 1) & 0xFF
        for t, d16, d8 in kept:
            slot = t >> bin_bits
            if slots[slot] != d8:
                emit.append((t, d16))
            slots[slot] = d8

    if not emit:
        return []

    # --- processQuery: u8-capped diag score per (t, diagonal) entry ---
    entries = []                   # [t, d16, capped u8 count]
    for t, d16 in emit:
        sc = _diag_score_exact(profile, index.seqs_masked[t], d16)
        entries.append([t, d16, min(sc, cap)])

    def _exact(e):
        return _diag_score_exact(profile, index.seqs_masked[e[0]], e[1])

    # --- radixSortByScoreSize(minDiagScoreThr): score desc, stable ---
    entries = [e for s in range(255, int(min_diag_score) - 1, -1)
               for e in entries if e[2] == s]

    # --- nucleotide saturated bucket: sort by id, overwrite the first
    #     entry's diagonal with the best exactly-rescored one ---
    n_sat = 0
    while n_sat < len(entries) and entries[n_sat][2] >= cap:
        n_sat += 1
    if n_sat:
        sat = sorted(entries[:n_sat], key=lambda e: e[0])
        prev_id = None
        mx = 0
        first_pos = 0
        for i, e in enumerate(sat):
            if prev_id == e[0]:
                new_score = _exact(e)
                if new_score > mx:
                    mx = new_score
                    sat[first_pos][1] = e[1]
            else:
                mx = (_exact(e) if i + 1 < len(sat)
                      and sat[i + 1][0] == e[0] else 0)
                first_pos = i
            prev_id = e[0]
        entries = sat + entries[n_sat:]

    # --- keepMaxScoreElementOnly: bin-ordered, first max per id ---
    by_bin = {}
    for e in entries:
        by_bin.setdefault(e[0] & bin_mask, []).append(e)
    kept = []
    for b in sorted(by_bin):
        best = {}
        for e in by_bin[b]:
            s = best.get(e[0])
            if s is None or e[2] > s:
                best[e[0]] = e[2]
        taken = set()
        for e in by_bin[b]:
            if e[0] not in taken and e[2] == best[e[0]]:
                kept.append(e)
                taken.add(e[0])
    entries = kept

    # --- threshold + getResult ---
    hist = np.zeros(256, dtype=np.int64)
    for e in entries:
        hist[e[2]] += 1
    found = 0
    thr = 0
    for s in range(255, 0, -1):
        found += hist[s]
        if found >= max_seqs:
            thr = s
            break
    diagonal_thr = max(min_diag_score, thr)

    if diagonal_thr >= cap:
        # rescoreHits escape (QueryMatcher.cpp:148-156): exact-rescore
        # every entry above the cap, rescale into u8, re-sort, thr=0
        above = [e for s in range(255, -1, -1)
                 for e in entries if e[2] == s and e[2] >= diagonal_thr]
        self_score = _diag_score_exact(
            profile, np.asarray(q_num, dtype=np.int64), 0)
        max_self = max(1, min(self_score - diagonal_thr, 65535))
        rescored = []
        for e in above:
            new_score = max(_exact(e) - diagonal_thr, 0)
            cnt8 = int(min(new_score, 65535) / max_self * 255 + 0.5)
            rescored.append([e[0], e[1], cnt8])
        rescored = [e for s in range(255, -1, -1)
                    for e in rescored if e[2] == s]
        rows = []
        for t, d16, cnt8 in rescored[:max_seqs]:
            score = (cap) + cnt8 * max_self // 255
            d = d16 - 65536 if d16 >= 32768 else d16
            rows.append((t, score, d))
        # the split-merge writer re-sorts (compareHitsByScoreAndId,
        # Prefiltering.cpp:450) — the aa path pinned the same order
        rows.sort(key=lambda r: (-abs(r[1]), r[0]))
        return rows

    # final radixSortByScoreSize(diagonalThr): desc, stable over the
    # keepMax bin order; getResult walks it until maxHitsPerQuery
    entries = [e for s in range(255, int(diagonal_thr) - 1, -1)
               for e in entries if e[2] == s]
    rows = []
    for t, d16, sc in entries[:max_seqs]:
        out_score = _exact([t, d16]) if sc >= cap else sc
        d = d16 - 65536 if d16 >= 32768 else d16
        rows.append((t, out_score, d))
    # the split-merge writer re-sorts (compareHitsByScoreAndId,
    # Prefiltering.cpp:450) — the aa path pinned the same order
    rows.sort(key=lambda r: (-abs(r[1]), r[0]))
    return rows
