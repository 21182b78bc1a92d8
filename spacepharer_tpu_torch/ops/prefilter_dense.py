"""Dense k-mer prefilter on the GPU (the device QueryMatcher).

The port of spacepharer_tpu/ops/prefilter_dense.py. The reference
prefilter enumerates the similar-k-mer set of each query k-mer
(KmerGenerator.cpp:186-), walks a postings index (IndexTable.h:25-38) and
streams (target, diagonal) matches into the dup filter
(QueryMatcher.cpp:84-323). This module re-derives the same match set
densely:

    K[i, j] = sum_p S80[q[i + off_p], t[j + off_p]]      (6 spaced offsets)
            = sum_p Qexp[i, p*21 + t[j + off_p]]

    Qexp[i, p*21 + a] = S80[q[i + off_p], a]   (host-built; int8 on the
                                                card, |S80| <= 127)

A target position j matches query k-mer i iff

    K[i, j] >= thr_i           (thr_i = max(kmerThr - bias_i, 0),
                                QueryMatcher.cpp:205-219)
    and j is a valid indexed k-mer (tval_j): self-score >= kmerThr, no X
    at the informative offsets, and the 8-residue span stays inside one
    target ORF (IndexBuilder.cpp:54-257 skip rules).

The index's "one posting per (code, seq) at its first position"
(IndexTable.h:341-) becomes a dedup over the hits, and the reference's
exact match-stream order is rebuilt per hit from the enumerator's
half-list ranks (hits_to_streams). The stream feeds the existing exact
host finalize (dup filter, ungapped diagonal rescore, max_seqs
selection), so the output is byte-identical to the host engine, and the
device path needs no postings index: only the tantan-masked flat target.

On the card two hand-written kernels (csrc/prefilter_dense.cu) do the
dense work, both as an int8 tensor-core product over the rows that can
match (compacted by compact_rows): prefilter_dense_counts counts the hits
of every (target tile, query tile) pair, and prefilter_dense_emit
recomputes only the tiles with hits, on their own compacted rows, and
writes each hit's coordinates. Each has a plain PyTorch version beside it
(a one-hot matmul), which the wrappers run on CPU tensors.

What the TPU version needed and this one does not: the fixed 8192-tile
target chunk and the power-of-two query-tile bucket (one compiled Mosaic
grid shape), the 32k query-row cap (a Mosaic compile once stalled on
more), and the host-side extraction of hit masks in batches of 64 tiles.
Chunks here are bounded by card memory alone (MAX_Q_ROWS, MAX_TILES,
MAX_EMIT_HITS).
"""
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .bias import round_half_away

X_IDX = 20
THR_INVALID = 1 << 30
TILE_Q = 256   # k-mer rows per tile
TILE_T = 512   # target positions per tile
KDIM = 128     # Qexp columns (6 * 21 = 126 used)
N_OFF = 6      # offsets the kernel reads (fewer: zero Qexp blocks)
MAX_K = N_OFF * 127   # no K of an int8 Qexp exceeds this: larger thr never hit
ROW_TILE = 128        # compacted rows per row tile of the counts kernel
# most hit tiles of one target tile that one block of the emit kernel
# takes (at most the kernel's kMaxRun, 256); output never depends on it
EMIT_RUN = 64

# Card-memory bounds of the kernel path; output never depends on them.
# A query chunk holds Qexp + thr on the card (132 B per row: 138 MB at
# MAX_Q_ROWS). A target chunk is sized so that its tile counts, the
# hit-tile list and its prefix sums (<= 28 B per tile) stay under 470 MB,
# and one emit launch writes at most MAX_EMIT_HITS hit coordinates
# (8 B each: 537 MB). Together well under 2 GB of the card's 80 GB.
MAX_Q_ROWS = 1 << 20
MAX_TILES = 1 << 24
MAX_EMIT_HITS = 1 << 26
# the plain version's K block per matmul (float32 elements: 256 MB;
# at least one tile of positions)
PLAIN_MAX_ELEMS = 1 << 26

# kernel launches made by the two wrappers, and the dense cells (query
# k-mer rows x target positions) the counts kernel covered; the plain
# CPU path counts in none of them
counts_launches = 0
emit_launches = 0
cells = 0
# None, or a list to which each counts or emit call appends a (start,
# stop) pair of CUDA events recorded around its kernel launch alone (the
# row compaction, the emit's run starts and its check left out)
launch_events = None


@dataclass
class QueryKmerBatch:
    """Flat-packed query k-mers of a key subset (host-side prep)."""
    keys: list
    q_flat: np.ndarray      # uint8 [NQ + span - 1] (X-padded tail)
    q_starts: np.ndarray    # int64 [len(keys) + 1] offsets into q_flat
    kmer_thr: np.ndarray    # int32 [NQ] per-position threshold
    kmer_valid: np.ndarray  # bool  [NQ]
    span: int
    offsets: np.ndarray
    n_rows: int             # NQ (k-mer start positions incl. invalid)


def build_query_batch(q_all, keys, bias80_all, params) -> QueryKmerBatch:
    """Pack the selected query ORFs into one flat k-mer batch.

    Validity/threshold semantics mirror prefilter_query: no X at the
    informative offsets, the last k-mer position of every ORF dropped
    (the indexTo quirk, CacheFriendlyOperations.cpp:43-46 +
    QueryMatcher.cpp:289-293), thr_i = max(kmerThr - biasK_i, 0)."""
    offsets = np.asarray(params.offsets)
    span = params.pattern_span
    kmer_thr = params.kmer_threshold()
    lens = [len(q_all[k]) for k in keys]
    starts = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    nq = int(starts[-1])
    q_flat = np.full(nq + span - 1, X_IDX, dtype=np.uint8)
    thr = np.full(nq, THR_INVALID, dtype=np.int32)
    valid = np.zeros(nq, dtype=bool)
    for ki, k in enumerate(keys):
        q = np.asarray(q_all[k], dtype=np.int64)
        L = len(q)
        q_flat[starts[ki]:starts[ki] + L] = q
        n_kmers = L - span + 1
        if n_kmers <= 0:
            continue
        v = np.ones(n_kmers, dtype=bool)
        for off in offsets:
            v &= q[off:off + n_kmers] != X_IDX
        v[n_kmers - 1] = False
        kpos = np.flatnonzero(v)
        if len(kpos) == 0:
            continue
        kbias = round_half_away(
            np.asarray(bias80_all[k])[kpos[:, None]
                                      + offsets[None, :]].sum(axis=1))
        thr[starts[ki] + kpos] = np.maximum(kmer_thr - kbias, 0)
        valid[starts[ki] + kpos] = True
    return QueryKmerBatch(keys=list(keys), q_flat=q_flat, q_starts=starts,
                          kmer_thr=thr, kmer_valid=valid, span=span,
                          offsets=offsets, n_rows=nq)


def build_qexp(batch: QueryKmerBatch, seed_scores: np.ndarray,
               pad_rows: int) -> np.ndarray:
    """Qexp[i, p*21+a] = S80[q[i+off_p], a], float32 [pad_rows, KDIM].

    Pad rows keep thr = THR_INVALID so they can never match."""
    assert int(np.abs(seed_scores).max()) < 256, \
        "seed matrix exceeds the bf16-exact integer range"
    out = np.zeros((pad_rows, KDIM), dtype=np.float32)
    s = seed_scores.astype(np.float32)
    n = batch.n_rows
    for p, off in enumerate(batch.offsets):
        out[:n, p * 21:(p + 1) * 21] = s[batch.q_flat[off:off + n]]
    return out


def target_boundary_valid(t_starts: np.ndarray, span: int) -> np.ndarray:
    """bool [t_res]: position j starts a k-mer fully inside one ORF.

    (The flat target has no separators; k-mers spanning two ORFs never
    exist in the reference index.)"""
    n = int(t_starts[-1])
    valid = np.ones(n, dtype=bool)
    s0 = np.asarray(t_starts[:-1], dtype=np.int64)
    s1 = np.asarray(t_starts[1:], dtype=np.int64)
    for o in range(1, span):
        idx = s1 - o
        ok = idx >= s0
        valid[idx[ok]] = False
    return valid


def match_pairs_numpy(batch: QueryKmerBatch, t_flat: np.ndarray,
                      t_bval: np.ndarray, seed_scores: np.ndarray,
                      kmer_thr: int, chunk: int = 1 << 16):
    """Oracle: all (gi, gj) with K >= thr_i over valid positions."""
    span = batch.span
    offsets = batch.offsets
    self_scores = np.diag(seed_scores).astype(np.int64)
    qexp = build_qexp(batch, seed_scores, batch.n_rows)
    thr = batch.kmer_thr.astype(np.float32)
    t_res = len(t_flat)
    gis, gjs = [], []
    for c0 in range(0, t_res, chunk):
        c1 = min(c0 + chunk, t_res)
        n = c1 - c0
        win = np.full(n + span - 1, X_IDX, dtype=np.uint8)
        avail = min(c1 + span - 1, t_res) - c0
        win[:avail] = t_flat[c0:c0 + avail]
        self_sc = np.zeros(n, dtype=np.int64)
        has_x = np.zeros(n, dtype=bool)
        texp = np.zeros((n, KDIM), dtype=np.float32)
        for p, off in enumerate(offsets):
            col = win[off:off + n]
            self_sc += self_scores[col]
            has_x |= col == X_IDX
            texp[np.arange(n), p * 21 + col] = 1.0
        tval = (self_sc >= kmer_thr) & ~has_x & t_bval[c0:c1]
        K = qexp @ texp.T
        mask = (K >= thr[:, None]) & tval[None, :]
        gi, gj = np.nonzero(mask)
        gis.append(gi.astype(np.int64))
        gjs.append(gj.astype(np.int64) + c0)
    if not gis:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(gis), np.concatenate(gjs)


# ---------------------------------------------------------------------------
# the dense pass: shared layout, plain versions, kernel wrappers
# ---------------------------------------------------------------------------
#
# Layout shared by the kernels and their plain versions:
#
#   qexp    int8  [R, KDIM]     build_qexp rows, R a multiple of TILE_Q
#   thr     int32 [R]           thr_i; THR_INVALID on invalid and pad rows
#   letters uint8 [>= C + max(offsets)]  target letters (<= X_IDX),
#                               X-padded past the target's end
#   tval    uint8 [C]           1 where position j is a valid k-mer,
#                               C a multiple of TILE_T
#   offs    N_OFF ints          the spaced offsets, padded with 0 (the
#                               Qexp blocks past the real ones are zero)
#
# Tile (tt, qt) covers rows qt*TILE_Q.. and positions tt*TILE_T..; its
# flat id is tt * nqt + qt, the index into counts.flatten().


def pad_offsets(offsets) -> tuple:
    """The spaced offsets as the N_OFF ints the kernels read."""
    offs = tuple(int(o) for o in offsets)
    if not 1 <= len(offs) <= N_OFF or 21 * len(offs) > KDIM:
        raise ValueError(f"the dense prefilter takes 1..{N_OFF} offsets")
    return offs + (0,) * (N_OFF - len(offs))


def prep(letters: torch.Tensor, bval: torch.Tensor, diag21: torch.Tensor,
         offsets, kmer_thr: int) -> torch.Tensor:
    """tval uint8 [C] of one target chunk (the port of _device_prep_fn):
    self-score >= kmer_thr, no X at the offsets, and bval (the k-mer
    stays inside one ORF). letters uint8 [C + span - 1], bval bool [C],
    diag21 int32 [21] the seed matrix's diagonal; on their device."""
    C = bval.numel()
    self_sc = torch.zeros(C, dtype=torch.int32, device=bval.device)
    has_x = torch.zeros(C, dtype=torch.bool, device=bval.device)
    for off in offsets:
        col = letters[off:off + C].long()
        self_sc += diag21[col]
        has_x |= col == X_IDX
    return ((self_sc >= kmer_thr) & ~has_x & bval).to(torch.uint8)


def _plain_blocks(qexp, thr, letters, tval, offsets):
    """Yield (c0, mask bool [R, w]) over target blocks of the plain
    version: K = qexp @ Texp^T by torch.matmul, then K >= thr_i and tval.
    Blocks are whole tiles, at most PLAIN_MAX_ELEMS cells each."""
    R, C = qexp.shape[0], tval.numel()
    dev = qexp.device
    qf = qexp.float()
    width = max(TILE_T, PLAIN_MAX_ELEMS // max(R, 1) // TILE_T * TILE_T)
    for c0 in range(0, C, width):
        w = min(width, C - c0)
        texp = torch.zeros((w, KDIM), dtype=torch.float32, device=dev)
        rows = torch.arange(w, device=dev)
        for p, off in enumerate(offsets):
            col = letters[c0 + off:c0 + off + w].long()
            texp[rows, p * 21 + col] = 1.0
        K = torch.matmul(qf, texp.T)                          # [R, w]
        yield c0, (K >= thr[:, None]) & (tval[None, c0:c0 + w] != 0)


def prefilter_dense_counts_plain(qexp, thr, letters, tval, offsets):
    """Plain PyTorch version of the counts kernel: int32 [ntt, nqt] hits
    per tile, same inputs (the shared layout above), on their device."""
    R, C = qexp.shape[0], tval.numel()
    nqt, ntt = R // TILE_Q, C // TILE_T
    out = torch.empty((ntt, nqt), dtype=torch.int32, device=qexp.device)
    for c0, mask in _plain_blocks(qexp, thr, letters, tval, offsets):
        w = mask.shape[1]
        per = mask.reshape(nqt, TILE_Q, w // TILE_T, TILE_T).sum(dim=(1, 3))
        out[c0 // TILE_T:(c0 + w) // TILE_T] = per.T.to(torch.int32)
    return out


def compact_rows(qexp, thr):
    """(qexp_c int8 [Rc, KDIM], thr_c int32 [Rc], q_tile int32 [Rc],
    row_id int32 [Rc], qt_start int32 [nqt + 1]): the rows that can match
    (thr <= MAX_K), in order, with their thresholds, their query tiles
    (row // TILE_Q) and their row indices, padded to a positive multiple
    of ROW_TILE with rows of threshold THR_INVALID (query tile 0, row 0);
    query tile qt owns the compacted rows qt_start[qt] ..
    qt_start[qt + 1] - 1. On qexp's device. The kernels read this form."""
    dev = qexp.device
    keep = torch.nonzero(thr <= MAX_K).flatten()
    n = keep.numel()
    rc = max(-(-n // ROW_TILE), 1) * ROW_TILE
    qexp_c = torch.zeros((rc, KDIM), dtype=torch.int8, device=dev)
    thr_c = torch.full((rc,), THR_INVALID, dtype=torch.int32, device=dev)
    q_tile = torch.zeros(rc, dtype=torch.int32, device=dev)
    row_id = torch.zeros(rc, dtype=torch.int32, device=dev)
    qexp_c[:n] = qexp[keep]
    thr_c[:n] = thr[keep]
    q_tile[:n] = (keep // TILE_Q).to(torch.int32)
    row_id[:n] = keep.to(torch.int32)
    qt_start = torch.searchsorted(
        q_tile[:n], torch.arange(qexp.shape[0] // TILE_Q + 1,
                                 dtype=torch.int32, device=dev),
        out_int32=True)
    return qexp_c, thr_c, q_tile, row_id, qt_start


def prefilter_dense_counts_compacted_plain(compacted, letters, tval,
                                           offsets, nqt: int):
    """Plain PyTorch version of the counts kernel on its own input, the
    compact_rows form: int32 [ntt, nqt], each compacted row's hits per
    target tile added into its query tile's count. Equals
    prefilter_dense_counts_plain on the rows compact_rows was given."""
    qexp_c, thr_c, q_tile, _, _ = compacted
    ntt = tval.numel() // TILE_T
    out = torch.zeros((ntt, nqt), dtype=torch.int64, device=qexp_c.device)
    for c0, mask in _plain_blocks(qexp_c, thr_c, letters, tval, offsets):
        per = mask.reshape(mask.shape[0], -1, TILE_T).sum(dim=2)  # [Rc, nt]
        out[c0 // TILE_T:c0 // TILE_T + per.shape[1]].index_add_(
            1, q_tile.long(), per.T)
    return out.to(torch.int32)


def prefilter_dense_emit_plain(qexp, thr, letters, tval, offsets, tiles,
                               base, tile_counts, total: int):
    """Plain PyTorch version of the emit kernel: (gi, gj) int32 [total],
    the hits of the listed tiles (flat ids `tiles`), tile k's hits at
    base[k] .. base[k] + tile_counts[k] - 1, row-major within a tile."""
    R, C = qexp.shape[0], tval.numel()
    nqt = R // TILE_Q
    dev = qexp.device
    slot_of = torch.full(((C // TILE_T) * nqt,), -1, dtype=torch.int64,
                         device=dev)
    slot_of[tiles] = torch.arange(tiles.numel(), device=dev)
    gis, gjs, slots = [], [], []
    for c0, mask in _plain_blocks(qexp, thr, letters, tval, offsets):
        gi, gj = torch.nonzero(mask, as_tuple=True)
        gj = gj + c0
        s = slot_of[(gj // TILE_T) * nqt + gi // TILE_Q]
        keep = s >= 0
        gis.append(gi[keep])
        gjs.append(gj[keep])
        slots.append(s[keep])
    gi, gj, s = torch.cat(gis), torch.cat(gjs), torch.cat(slots)
    if gi.numel() != total:
        raise RuntimeError(f"prefilter_dense_emit_plain: {gi.numel()} hits "
                           f"in the listed tiles, the counts say {total}")
    order = torch.sort(s, stable=True).indices
    return gi[order].to(torch.int32), gj[order].to(torch.int32)


def prefilter_dense_emit_compacted_plain(compacted, letters, tval, offsets,
                                         nqt: int, tiles, base, tile_counts,
                                         total: int):
    """Plain PyTorch version of the emit kernel on its own input, the
    compact_rows form of nqt query tiles: (gi, gj) int32 [total], the
    hits of the listed tiles, tile k's at base[k] .. base[k] +
    tile_counts[k] - 1, row-major within a tile. Equals
    prefilter_dense_emit_plain on the rows compact_rows was given."""
    qexp_c, thr_c, q_tile, row_id, _ = compacted
    dev = qexp_c.device
    slot_of = torch.full(((tval.numel() // TILE_T) * nqt,), -1,
                         dtype=torch.int64, device=dev)
    slot_of[tiles] = torch.arange(tiles.numel(), device=dev)
    gis, gjs, slots = [], [], []
    for c0, mask in _plain_blocks(qexp_c, thr_c, letters, tval, offsets):
        ci, gj = torch.nonzero(mask, as_tuple=True)
        gj = gj + c0
        s = slot_of[(gj // TILE_T) * nqt + q_tile[ci].long()]
        keep = s >= 0
        gis.append(row_id[ci[keep]].long())
        gjs.append(gj[keep])
        slots.append(s[keep])
    gi, gj, s = torch.cat(gis), torch.cat(gjs), torch.cat(slots)
    if gi.numel() != total:
        raise RuntimeError(f"prefilter_dense_emit_compacted_plain: "
                           f"{gi.numel()} hits in the listed tiles, the "
                           f"counts say {total}")
    order = torch.sort(s, stable=True).indices
    return gi[order].to(torch.int32), gj[order].to(torch.int32)


def emit_runs(tiles, nqt: int, max_run: int):
    """int32 [n_runs + 1]: the emit kernel's runs of the listed tiles
    (flat ids, ascending), each at most max_run consecutive tiles of one
    target tile, run r being tiles run[r] .. run[r + 1] - 1; on tiles'
    device."""
    n = tiles.numel()
    tt = tiles // nqt
    # each tile's rank among the listed tiles of its target tile
    rank = torch.arange(n, device=tiles.device) - torch.searchsorted(tt, tt)
    starts = torch.nonzero(rank % max_run == 0).flatten()
    return torch.cat([starts, torch.tensor([n], device=tiles.device)]).to(
        torch.int32)


def _check(name, x, dtype, dev):
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"prefilter_dense: {name} must be a contiguous "
                         f"{dtype} tensor on {dev}, got {x.dtype} on "
                         f"{x.device}")


def _check_layout(qexp, thr, letters, tval, offs):
    dev = qexp.device
    for name, x, dtype in (("qexp", qexp, torch.int8),
                           ("thr", thr, torch.int32),
                           ("letters", letters, torch.uint8),
                           ("tval", tval, torch.uint8)):
        _check(name, x, dtype, dev)
    R, C = qexp.shape[0], tval.numel()
    if qexp.dim() != 2 or qexp.shape[1] != KDIM or R % TILE_Q or R == 0:
        raise ValueError(f"prefilter_dense: qexp must be [R, {KDIM}] with R "
                         f"a positive multiple of {TILE_Q}")
    if thr.numel() != R:
        raise ValueError("prefilter_dense: thr must have one entry per row")
    if C % TILE_T or C == 0:
        raise ValueError(f"prefilter_dense: tval length must be a positive "
                         f"multiple of {TILE_T}")
    if letters.numel() < C + max(offs):
        raise ValueError("prefilter_dense: letters must cover every "
                         "position's k-mer")
    if C > 0x7fffffff or (C // TILE_T) * (R // TILE_Q) > 0x7fffffff:
        raise ValueError("prefilter_dense: too many positions or tiles for "
                         "one launch")
    if qexp.data_ptr() % 16:
        raise ValueError("prefilter_dense: qexp must be 16-byte aligned")


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _checked_compacted(qexp, thr, compacted):
    """compact_rows(qexp, thr), or `compacted` (its output for these
    qexp and thr) after checking its layout."""
    if compacted is None:
        return compact_rows(qexp, thr)
    dev = qexp.device
    qexp_c, thr_c, q_tile, row_id, qt_start = compacted
    for name, x, dtype in (("compacted qexp", qexp_c, torch.int8),
                           ("compacted thr", thr_c, torch.int32),
                           ("compacted q_tile", q_tile, torch.int32),
                           ("compacted row_id", row_id, torch.int32),
                           ("compacted qt_start", qt_start, torch.int32)):
        _check(name, x, dtype, dev)
    rc = qexp_c.shape[0]
    if (qexp_c.dim() != 2 or qexp_c.shape[1] != KDIM or rc % ROW_TILE
            or rc == 0 or thr_c.numel() != rc or q_tile.numel() != rc
            or row_id.numel() != rc
            or qt_start.numel() != qexp.shape[0] // TILE_Q + 1):
        raise ValueError(f"prefilter_dense: compacted rows must be [Rc, "
                         f"{KDIM}] with Rc a positive multiple of "
                         f"{ROW_TILE}, one threshold, query tile and row "
                         f"id each, and one start per query tile")
    if qexp_c.data_ptr() % 16 or thr_c.data_ptr() % 16:
        raise ValueError("prefilter_dense: compacted rows must be 16-byte "
                         "aligned")
    return compacted


def prefilter_dense_counts(qexp, thr, letters, tval, offsets,
                           compacted=None):
    """int32 [ntt, nqt] hits per (target tile, query tile), the port of
    the TPU counts kernel (layout: the comment above pad_offsets).

    On CUDA tensors this compacts the rows that can match (compact_rows,
    or takes `compacted`, its output for these qexp and thr, made once
    per query chunk) and launches csrc/prefilter_dense.cu, and raises if
    the kernel cannot be built or launched; on CPU tensors it runs
    prefilter_dense_counts_plain."""
    global counts_launches, cells
    offs = pad_offsets(offsets)
    dev = qexp.device
    if dev.type == "cpu":
        return prefilter_dense_counts_plain(qexp, thr, letters, tval, offsets)
    if dev.type != "cuda":
        raise ValueError(f"prefilter_dense_counts: unsupported device {dev}")
    _check_layout(qexp, thr, letters, tval, offs)
    qexp_c, thr_c, q_tile, _, _ = _checked_compacted(qexp, thr, compacted)
    rc = qexp_c.shape[0]
    from ._cuda import library
    lib = library("prefilter_dense")
    if lib.prefilter_dense_row_tile() != ROW_TILE:
        raise RuntimeError("prefilter_dense: ROW_TILE disagrees with the "
                           "kernel")
    R, C = qexp.shape[0], tval.numel()
    out = torch.zeros((C // TILE_T, R // TILE_Q), dtype=torch.int32,
                      device=dev)
    stream = torch.cuda.current_stream(dev)
    events = None
    if launch_events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(stream)
    err = lib.prefilter_dense_counts_launch(
        _ptr(qexp_c), _ptr(thr_c), _ptr(q_tile), _ptr(letters), _ptr(tval),
        (ctypes.c_int * N_OFF)(*offs), ctypes.c_int(rc),
        ctypes.c_int(R // TILE_Q), ctypes.c_int(C // TILE_T), _ptr(out),
        ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"prefilter_dense_counts kernel launch failed: "
                           f"CUDA error {err}")
    if events is not None:
        events[1].record(stream)
        launch_events.append(events)
    counts_launches += 1
    cells += R * C
    return out


def prefilter_dense_emit(qexp, thr, letters, tval, offsets, tiles, base,
                         tile_counts, total: int, compacted=None):
    """(gi, gj) int32 [total]: row and position of every hit of the
    listed tiles, the port of the TPU path's hit extraction. tiles int64
    [n] flat tile ids in ascending order, base int64 [n] exclusive prefix
    sums of tile_counts int32 [n] (the tiles' counts); tile k's hits land
    in base[k] .. base[k] + tile_counts[k] - 1, in no fixed order inside
    it.

    On CUDA tensors this takes the compacted rows (compact_rows, or
    `compacted`, as prefilter_dense_counts does), cuts the listed tiles
    into runs of at most EMIT_RUN tiles of one target tile (emit_runs),
    launches csrc/prefilter_dense.cu, checks that every tile wrote
    exactly its count, and raises if the kernel cannot be built or
    launched or the check fails; on CPU tensors it runs
    prefilter_dense_emit_plain."""
    global emit_launches
    offs = pad_offsets(offsets)
    dev = qexp.device
    if dev.type == "cpu":
        return prefilter_dense_emit_plain(qexp, thr, letters, tval, offsets,
                                          tiles, base, tile_counts, total)
    if dev.type != "cuda":
        raise ValueError(f"prefilter_dense_emit: unsupported device {dev}")
    _check_layout(qexp, thr, letters, tval, offs)
    for name, x, dtype in (("tiles", tiles, torch.int64),
                           ("base", base, torch.int64),
                           ("tile_counts", tile_counts, torch.int32)):
        _check(name, x, dtype, dev)
    n = tiles.numel()
    if base.numel() != n or tile_counts.numel() != n:
        raise ValueError("prefilter_dense_emit: tiles, base and tile_counts "
                         "must have one entry per tile")
    if n > 0x7fffffff or total > 0x7fffffff:
        raise ValueError("prefilter_dense_emit: too many tiles or hits for "
                         "one launch")
    gi = torch.empty(total, dtype=torch.int32, device=dev)
    gj = torch.empty(total, dtype=torch.int32, device=dev)
    if n == 0:
        return gi, gj
    if not bool((tiles[1:] > tiles[:-1]).all()):
        raise ValueError("prefilter_dense_emit: tiles must be ascending")
    qexp_c, thr_c, _, row_id, qt_start = _checked_compacted(qexp, thr,
                                                            compacted)
    nqt = qexp.shape[0] // TILE_Q
    runs = emit_runs(tiles, nqt, EMIT_RUN)
    from ._cuda import library
    lib = library("prefilter_dense")
    written = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    events = None
    if launch_events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(stream)
    err = lib.prefilter_dense_emit_launch(
        _ptr(qexp_c), _ptr(thr_c), _ptr(row_id), _ptr(qt_start),
        _ptr(letters), _ptr(tval), (ctypes.c_int * N_OFF)(*offs),
        ctypes.c_int(nqt), _ptr(tiles), _ptr(runs),
        ctypes.c_int(runs.numel() - 1), ctypes.c_int(EMIT_RUN), _ptr(base),
        _ptr(tile_counts), _ptr(gi), _ptr(gj), _ptr(written),
        ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"prefilter_dense_emit kernel launch failed: "
                           f"CUDA error {err}")
    if events is not None:
        events[1].record(stream)
        launch_events.append(events)
    emit_launches += 1
    if not torch.equal(written, tile_counts):
        raise RuntimeError(f"prefilter_dense_emit: the tiles wrote "
                           f"{int(written.sum())} hits, the counts say "
                           f"{total}")
    return gi, gj


def build_qexp_i8(batch: QueryKmerBatch, seed_scores: np.ndarray):
    """(qexp int8 [R, KDIM], thr int32 [R]) of a batch, R its row count
    rounded up to whole query tiles; pad rows never match."""
    if int(np.abs(seed_scores).max()) > 127:
        raise ValueError("the seed matrix exceeds the int8 range")
    R = max(-(-batch.n_rows // TILE_Q), 1) * TILE_Q
    qexp = build_qexp(batch, seed_scores, R).astype(np.int8)
    thr = np.full(R, THR_INVALID, dtype=np.int32)
    thr[:batch.n_rows] = batch.kmer_thr
    return qexp, thr


def target_chunk(batch: QueryKmerBatch, t_flat: np.ndarray,
                 t_bval: np.ndarray, seed_scores: np.ndarray, kmer_thr: int,
                 c0: int, C: int, device):
    """(letters, tval) of target positions c0 .. c0 + C - 1 on `device`:
    the letters X-padded past the target's end, tval from prep. C is a
    multiple of TILE_T."""
    span = batch.span
    t_res = len(t_flat)
    letters = np.full(C + span - 1, X_IDX, dtype=np.uint8)
    avail = max(min(c0 + C + span - 1, t_res) - c0, 0)
    letters[:avail] = t_flat[c0:c0 + avail]
    bval = np.zeros(C, dtype=bool)
    bn = max(min(c0 + C, t_res) - c0, 0)
    bval[:bn] = t_bval[c0:c0 + bn]
    letters_d = torch.from_numpy(letters).to(device)
    diag21 = torch.from_numpy(
        np.diag(seed_scores)[:21].astype(np.int32)).to(device)
    return letters_d, prep(letters_d, torch.from_numpy(bval).to(device),
                           diag21, tuple(int(o) for o in batch.offsets),
                           int(kmer_thr))


def dense_inputs(batch: QueryKmerBatch, t_flat: np.ndarray,
                 t_bval: np.ndarray, seed_scores: np.ndarray, kmer_thr: int,
                 device):
    """(qexp, thr, letters, tval, offsets): the kernels' inputs (the
    shared layout) for one chunk holding the batch and the whole
    target, on `device`."""
    qexp, thr = build_qexp_i8(batch, seed_scores)
    C = max(-(-len(t_flat) // TILE_T), 1) * TILE_T
    letters, tval = target_chunk(batch, t_flat, t_bval, seed_scores,
                                 kmer_thr, 0, C, device)
    return (torch.from_numpy(qexp).to(device),
            torch.from_numpy(thr).to(device), letters, tval,
            tuple(int(o) for o in batch.offsets))


def hit_tiles(counts: torch.Tensor):
    """(tiles, base, tile_counts, total): the emit pass's arguments for
    the tiles with hits, on counts' device: flat tile ids (int64), the
    exclusive prefix sums of their counts (int64), the counts (int32),
    and the number of hits."""
    flat = counts.flatten()
    tiles = torch.nonzero(flat).flatten()
    tc = flat[tiles]
    return (tiles, torch.cumsum(tc, 0, dtype=torch.int64) - tc, tc,
            int(tc.sum()))


def match_pairs(batch: QueryKmerBatch, t_flat: np.ndarray,
                t_bval: np.ndarray, seed_scores: np.ndarray, kmer_thr: int,
                device="cuda"):
    """(gi, gj) int64 numpy: every query k-mer row gi of the batch and
    target position gj with K >= thr_gi and a valid k-mer at gj, found
    by the counts and emit passes on `device` (the kernels on a GPU, the
    plain versions on the CPU). Hits come in no fixed order."""
    dev = torch.device(device)
    t_flat = np.asarray(t_flat)
    t_res = len(t_flat)
    if t_res and int(t_flat.max()) > X_IDX:
        raise ValueError("target letters must lie in [0, 20]")
    offsets = tuple(int(o) for o in batch.offsets)
    qexp_np, thr_np = build_qexp_i8(batch, seed_scores)
    qexp = torch.from_numpy(qexp_np).to(dev)
    thr = torch.from_numpy(thr_np).to(dev)
    nqt = qexp_np.shape[0] // TILE_Q
    # the kernels' compacted rows, once for every target chunk
    compacted = compact_rows(qexp, thr) if dev.type == "cuda" else None
    # target chunk: MAX_TILES tiles, positions addressable in int32
    C = min(max(MAX_TILES // nqt, 1) * TILE_T, 1 << 30,
            max(-(-t_res // TILE_T), 1) * TILE_T)
    gis, gjs = [], []
    for c0 in range(0, t_res, C):
        letters, tval = target_chunk(batch, t_flat, t_bval, seed_scores,
                                     kmer_thr, c0, C, dev)
        tiles, base, tc, _ = hit_tiles(prefilter_dense_counts(
            qexp, thr, letters, tval, offsets, compacted))
        base_np = base.cpu().numpy()
        ends_np = base_np + tc.cpu().numpy()
        # one emit launch per run of hit tiles holding <= MAX_EMIT_HITS
        lo = 0
        while lo < len(ends_np):
            start = int(base_np[lo])
            hi = max(int(np.searchsorted(ends_np, start + MAX_EMIT_HITS,
                                         side="right")), lo + 1)
            gi, gj = prefilter_dense_emit(
                qexp, thr, letters, tval, offsets, tiles[lo:hi],
                base[lo:hi] - start, tc[lo:hi],
                int(ends_np[hi - 1]) - start, compacted)
            gis.append(gi.cpu().numpy().astype(np.int64))
            gjs.append(gj.cpu().numpy().astype(np.int64) + c0)
            lo = hi
    if not gis:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gi = np.concatenate(gis)
    gj = np.concatenate(gjs)
    keep = (gi < batch.n_rows) & (gj < t_res)
    return gi[keep], gj[keep]


# ---------------------------------------------------------------------------
# reference-order stream reconstruction + finalize
# ---------------------------------------------------------------------------

# distinct query halves whose rank tables hits_to_streams gathers from
# at once: 2,048 x 8,000 int16 = 32 MB
RANK_CHUNK = 2048
# bits of hits_to_streams' one sort key (row, rank 1, rank 2, target);
# wider keys sort lexicographically instead
KEY_BITS = 63


def _half_ranks(batch, gi, codes, enumerator):
    """(r1, r2): for every hit, the rank of its target half-codes
    `codes` (two [n] arrays) in the enumeration order of its query
    row's two halves, from enumerator.half_rank's cached tables. Each
    row's halves are coded once (letters in base 21, X included), and
    the tables of the halves that occur are stacked RANK_CHUNK at a
    time."""
    half = enumerator.half
    base = X_IDX + 1
    rows = np.arange(batch.n_rows)
    letters = batch.q_flat[rows[:, None] + np.asarray(batch.offsets)[None, :]]
    hid = []
    for h in range(2):
        code = np.zeros(batch.n_rows, dtype=np.int64)
        for j in range(half):
            code = code * base + letters[:, h * half + j]
        hid.append(code[gi])
    present = np.zeros(base ** half, dtype=bool)
    present[hid[0]] = True
    present[hid[1]] = True
    uniq = np.flatnonzero(present)
    slot = np.zeros(base ** half, dtype=np.int64)
    slot[uniq] = np.arange(len(uniq))
    tris = np.stack([uniq // base ** (half - 1 - j) % base
                     for j in range(half)], axis=1)
    ranks = [np.empty(len(gi), dtype=np.int64) for _ in range(2)]
    sids = [slot[h] for h in hid]
    for lo in range(0, len(uniq), RANK_CHUNK):
        hi = min(lo + RANK_CHUNK, len(uniq))
        tabs = np.stack([enumerator.half_rank(tri) for tri in tris[lo:hi]]
                        ).astype(np.int16)
        for sid, code, r in zip(sids, codes, ranks):
            sel = (sid >= lo) & (sid < hi)
            r[sel] = tabs[sid[sel] - lo, code[sel]]
    return ranks


def hits_to_streams(batch: QueryKmerBatch, gi, gj, t_flat, t_starts,
                    enumerator) -> dict:
    """Map (gi, gj) pairs to per-query (m_t, m_d) match streams in the
    reference's exact emission order: k-mer position ascending, then
    KmerGenerator enumeration order — (half-1 rank, half-2 rank) under
    each half-list's (score desc, code asc) sort (KmerGenerator.cpp:
    186-) — then target sequence ascending; one entry per (code, seq)
    at its first target position (IndexTable.h:341- unique-insert).

    One sort over every hit of the batch: the query row gi orders keys
    and k-mer positions at once, so (gi, rank 1, rank 2, target) is the
    sort key; each run of one key keeps its first target position, and
    the streams split by key."""
    offsets = np.asarray(batch.offsets)
    t_starts = np.asarray(t_starts, dtype=np.int64)
    gi = np.asarray(gi, dtype=np.int64)
    gj = np.asarray(gj, dtype=np.int64)
    n_seqs = len(t_starts) - 1
    seq_of = np.repeat(np.arange(n_seqs, dtype=np.int64), np.diff(t_starts))
    t_seq = seq_of[gj]
    t_pos = gj - t_starts[t_seq]
    letters = t_flat[gj[:, None] + offsets[None, :]].astype(np.int64)
    c1 = letters[:, 0] * 400 + letters[:, 1] * 20 + letters[:, 2]
    c2 = letters[:, 3] * 400 + letters[:, 4] * 20 + letters[:, 5]
    r1, r2 = _half_ranks(batch, gi, (c1, c2), enumerator)
    n_half = enumerator.n_half
    row_code = (gi * n_half + r1) * n_half + r2
    seq_bits = max(n_seqs - 1, 1).bit_length()
    if (int(row_code.max(initial=0)).bit_length() + seq_bits) <= KEY_BITS:
        key = (row_code << seq_bits) | t_seq
        srt = np.argsort(key)
        key = key[srt]
        first = np.ones(len(srt), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        runs = np.flatnonzero(first)
        pos = (np.minimum.reduceat(t_pos[srt], runs) if len(runs)
               else t_pos[:0])
        gi, m_t = gi[srt][runs], t_seq[srt][runs]
    else:
        srt = np.lexsort((t_pos, t_seq, row_code))
        row_code, t_seq = row_code[srt], t_seq[srt]
        first = np.ones(len(srt), dtype=bool)
        first[1:] = ((row_code[1:] != row_code[:-1])
                     | (t_seq[1:] != t_seq[:-1]))
        gi, m_t, pos = gi[srt][first], t_seq[first], t_pos[srt][first]
    q_starts = np.asarray(batch.q_starts)
    key_of = np.searchsorted(q_starts, gi, side="right") - 1
    m_d = (gi - q_starts[key_of] - pos) & 0xFFFF
    bounds = np.searchsorted(key_of, np.arange(len(batch.keys) + 1))
    return {k: (m_t[bounds[i]:bounds[i + 1]], m_d[bounds[i]:bounds[i + 1]])
            for i, k in enumerate(batch.keys)}


def device_prefilter(q_all, keys, bias80_all, t_flat_masked, t_starts,
                     params, enumerator, seed_m, ungapped_m,
                     device="cuda") -> dict:
    """Full dense prefilter: {key: [PrefilterHit]} byte-identical to
    prefilter_query (the match set/stream is exact; the dup filter,
    diagonal rescore and max_seqs selection run in the existing host
    finalize on the reconstructed stream). The dense pass runs on
    `device`; everything returned is host data."""
    from .prefilter import (TargetIndex, _finalize_native, _finalize_py,
                            ungapped_profile_cap)
    from ..native import get_lib

    t_flat_masked = np.ascontiguousarray(t_flat_masked, dtype=np.uint8)
    t_starts = np.asarray(t_starts, dtype=np.int64)
    t_bval = target_boundary_valid(t_starts, params.pattern_span)
    kmer_thr = params.kmer_threshold()

    # query-side chunking: keys stream through the card in groups of at
    # most MAX_Q_ROWS residues (card memory, see MAX_Q_ROWS); per-key
    # output is unaffected
    key_chunks = []
    cur, cur_rows = [], 0
    for k in keys:
        n = len(q_all[k])
        if cur and cur_rows + n > MAX_Q_ROWS:
            key_chunks.append(cur)
            cur, cur_rows = [], 0
        cur.append(k)
        cur_rows += n
    if cur or not key_chunks:
        key_chunks.append(cur)

    streams = {}
    for kchunk in key_chunks:
        batch = build_query_batch(q_all, kchunk, bias80_all, params)
        gi, gj = match_pairs(batch, t_flat_masked, t_bval, seed_m.scores,
                             kmer_thr, device=device)
        streams.update(hits_to_streams(batch, gi, gj, t_flat_masked,
                                       t_starts, enumerator))

    # finalize needs the masked sequences (rescoring) but no postings
    n_seqs = len(t_starts) - 1
    shim = TargetIndex(
        seqs_masked=[t_flat_masked[t_starts[i]:t_starts[i + 1]]
                     for i in range(n_seqs)],
        seq_lengths=np.diff(t_starts),
        post_seq=np.zeros(0, np.int32), post_pos=np.zeros(0, np.uint16),
        uniq_codes=np.zeros(0, np.int64), uniq_start=np.zeros(1, np.int64),
        uniq_letters=np.zeros((0, params.kmer_size), np.int8),
        db_residues=int(t_starts[-1]),
        flat_masked=t_flat_masked, masked_starts=t_starts)
    lib = get_lib()
    out = {}
    for k in keys:
        m_t, m_d = streams[k]
        if len(m_t) == 0:
            out[k] = []
            continue
        profile, cap = ungapped_profile_cap(
            np.asarray(q_all[k], dtype=np.int64), bias80_all[k], ungapped_m)
        q_num = np.asarray(q_all[k], dtype=np.int64)
        if lib is not None:
            out[k] = _finalize_native(lib, m_t, m_d, shim, profile, cap,
                                      params, q_num)
        else:
            out[k] = _finalize_py(m_t, m_d, shim, profile, cap, params,
                                  q_num)
    return out
