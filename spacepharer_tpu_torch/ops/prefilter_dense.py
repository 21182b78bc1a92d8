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
exact match-stream order is rebuilt per hit from the half-list ranks
(rebuild_streams, on the card: csrc/prefilter_streams.cu). The streams
feed the exact host finalize (dup filter, ungapped diagonal rescore,
max_seqs selection; one threaded native call over every key), so the
output is byte-identical to the host engine, and the device path needs
no postings index: only the tantan-masked flat target.

On the card one hand-written kernel (csrc/prefilter_dense.cu) does the
dense work in one pass, as an int8 tensor-core product over the rows that
can match (compacted by compact_rows): prefilter_dense_hits writes every
hit's coordinates into an append buffer as it finds them. Its plain
PyTorch version beside it (a one-hot matmul) runs on CPU tensors.

What the TPU version needed and this one does not: the fixed 8192-tile
target chunk and the power-of-two query-tile bucket (one compiled Mosaic
grid shape), the 32k query-row cap (a Mosaic compile once stalled on
more), and the per-tile hit counts whose tiles were computed again, to
extract their hit masks on the host in batches of 64 tiles. Chunks here
are bounded by card memory alone (MAX_Q_ROWS, MAX_CHUNK, HIT_CAPACITY).
"""
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..logging import count, span
from ._cuda import I64, INT, INTS, PTR, Entry, check, on_card, upload
from .bias import round_half_away

X_IDX = 20
THR_INVALID = 1 << 30
TILE_Q = 256   # k-mer rows per tile
TILE_T = 512   # target positions per tile
KDIM = 128     # Qexp columns (6 * 21 = 126 used)
N_OFF = 6      # offsets the kernel reads (fewer: zero Qexp blocks)
MAX_K = N_OFF * 127   # no K of an int8 Qexp exceeds this: larger thr never hit
ROW_TILE = 128        # compacted rows per stage of the kernel
MAX_OFFSET = 127      # largest spaced offset the kernel takes

# Memory bounds of the dense pass; output never depends on them. A query
# chunk holds Qexp + thr on the card (132 B per row: 138 MB at
# MAX_Q_ROWS). A target chunk covers at most MAX_CHUNK positions, so that
# the temporaries of its tval (prep: about 18 B a position) stay near 1.2
# GB; its positions fit int32 with room to spare. The hit buffer holds
# HIT_CAPACITY hits (8 B each: 537 MB), allocated once per device
# (hit_buffer); a chunk with more hits runs again into a buffer of
# exactly its hits.
MAX_Q_ROWS = 1 << 20
MAX_CHUNK = 1 << 26
HIT_CAPACITY = 1 << 26
# the plain version's K block per matmul (float32 elements: 256 MB;
# at least one tile of positions)
PLAIN_MAX_ELEMS = 1 << 26

# The wrapper counts its launches in the registry (logging.count):
# prefilter_dense_hits_launches, and in prefilter_dense_hits_cells the
# cells (compacted rows x target positions) the kernel covered; the plain
# CPU path counts in neither.
_HITS = Entry("prefilter_dense", "prefilter_dense_hits",
              (PTR, PTR, PTR, PTR, PTR, INTS, INT, INT, PTR, PTR, I64, PTR),
              counter="prefilter_dense_hits",
              cells_counter="prefilter_dense_hits_cells",
              constants={"prefilter_dense_row_tile": ROW_TILE,
                         "prefilter_dense_max_offset": MAX_OFFSET})


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


def flat_keys(arrays, keys, dtype):
    """(flat, starts): arrays[k] of every key in `keys`, concatenated as
    `dtype`, and their int64 offsets [len(keys) + 1]."""
    starts = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(arrays[k]) for k in keys), np.int64,
                          len(keys)), out=starts[1:])
    if not starts[-1]:
        return np.zeros(0, dtype=dtype), starts
    return np.concatenate([arrays[k] for k in keys], dtype=dtype,
                          casting="unsafe"), starts


def build_query_batch(q_all, keys, bias80_all, params) -> QueryKmerBatch:
    """Pack the selected query ORFs into one flat k-mer batch.

    Validity/threshold semantics mirror prefilter_query: no X at the
    informative offsets, the last k-mer position of every ORF dropped
    (the indexTo quirk, CacheFriendlyOperations.cpp:43-46 +
    QueryMatcher.cpp:289-293), thr_i = max(kmerThr - biasK_i, 0). One
    pass over the flat batch: row i of an ORF of length L is valid iff
    i < L - span (its k-mer fits, and it is not the last one) and its
    letters at the offsets are not X; its bias sum adds the offsets in
    order, as the per-ORF sum did."""
    offsets = np.asarray(params.offsets)
    span = params.pattern_span
    q, starts = flat_keys(q_all, keys, np.uint8)
    nq = int(starts[-1])
    q_flat = np.full(nq + span - 1, X_IDX, dtype=np.uint8)
    q_flat[:nq] = q
    lens = np.diff(starts)
    local = np.arange(nq) - np.repeat(starts[:-1], lens)
    valid = local < np.repeat(lens - span, lens)
    for off in offsets:
        valid &= q_flat[off:off + nq] != X_IDX
    kpos = np.flatnonzero(valid)
    bias = flat_keys(bias80_all, keys, np.float64)[0]
    kbias = round_half_away(bias[kpos[:, None] + offsets[None, :]].sum(axis=1))
    thr = np.full(nq, THR_INVALID, dtype=np.int32)
    thr[kpos] = np.maximum(params.kmer_threshold() - kbias, 0)
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
# the dense pass: shared layout, plain version, kernel wrapper
# ---------------------------------------------------------------------------
#
# Layout shared by the kernel and its plain version (the kernel takes the
# rows compacted by compact_rows):
#
#   qexp    int8  [R, KDIM]     build_qexp rows, R a multiple of TILE_Q
#   thr     int32 [R]           thr_i; THR_INVALID on invalid and pad rows
#   letters uint8 [>= C + max(offsets)]  target letters (<= X_IDX),
#                               X-padded past the target's end
#   tval    uint8 [C]           1 where position j is a valid k-mer,
#                               C a multiple of TILE_T
#   offs    N_OFF ints          the spaced offsets, padded with 0 (the
#                               Qexp blocks past the real ones are zero)


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


def compact_rows(qexp, thr):
    """(qexp_c int8 [Rc, KDIM], thr_c int32 [Rc], row_id int32 [Rc]): the
    rows that can match (thr <= MAX_K), in order, with their thresholds
    and their row indices, padded to a positive multiple of ROW_TILE with
    rows of threshold THR_INVALID (row 0). On qexp's device. The kernel
    reads this form."""
    dev = qexp.device
    keep = torch.nonzero(thr <= MAX_K).flatten()
    n = keep.numel()
    rc = max(-(-n // ROW_TILE), 1) * ROW_TILE
    qexp_c = torch.zeros((rc, KDIM), dtype=torch.int8, device=dev)
    thr_c = torch.full((rc,), THR_INVALID, dtype=torch.int32, device=dev)
    row_id = torch.zeros(rc, dtype=torch.int32, device=dev)
    qexp_c[:n] = qexp[keep]
    thr_c[:n] = thr[keep]
    row_id[:n] = keep.to(torch.int32)
    return qexp_c, thr_c, row_id


def new_hit_buffer(capacity: int, device):
    """(gi int32 [capacity], gj int32 [capacity], cursor int64 [1]): an
    append buffer of the dense pass on `device`."""
    return (torch.empty(capacity, dtype=torch.int32, device=device),
            torch.empty(capacity, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))


_hit_buffers = {}   # device -> the buffer of HIT_CAPACITY hits


def hit_buffer(device):
    """The append buffer of HIT_CAPACITY hits on `device` (new_hit_buffer),
    allocated at its first use and kept for every later chunk, search and
    call of the process."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:   # one buffer per card
        dev = torch.device("cuda", torch.cuda.current_device())
    buf = _hit_buffers.get(dev)
    if buf is None or buf[0].numel() != HIT_CAPACITY:
        buf = _hit_buffers[dev] = new_hit_buffer(HIT_CAPACITY, dev)
    return buf


def prefilter_dense_hits_plain(compacted, letters, tval, offsets, gi, gj,
                               cursor):
    """Plain PyTorch version of the kernel, on its inputs' device: every
    hit of the compacted rows (compact_rows) against the target chunk
    (letters, tval; the shared layout above) by a one-hot matmul and
    torch.nonzero. cursor (int64 [1]) gets the number of hits; hit k,
    for k below gi's length, is written at gi[k] (its row's original id)
    and gj[k] (its chunk-relative position); the rest are counted only."""
    qexp_c, thr_c, row_id = compacted
    cap, n = gi.numel(), 0
    for c0, mask in _plain_blocks(qexp_c, thr_c, letters, tval, offsets):
        ci, j = torch.nonzero(mask, as_tuple=True)
        k = min(max(cap - n, 0), ci.numel())
        gi[n:n + k] = row_id[ci[:k]]
        gj[n:n + k] = (j[:k] + c0).to(torch.int32)
        n += ci.numel()
    cursor.fill_(n)


def _check_inputs(compacted, letters, tval, offs, gi, gj, cursor):
    """Raise unless the kernel takes these inputs (the shared layout and
    compact_rows' form, on one device)."""
    qexp_c, thr_c, row_id = compacted
    dev = qexp_c.device
    for name, x, dtype in (("compacted qexp", qexp_c, torch.int8),
                           ("compacted thr", thr_c, torch.int32),
                           ("compacted row_id", row_id, torch.int32),
                           ("letters", letters, torch.uint8),
                           ("tval", tval, torch.uint8),
                           ("gi", gi, torch.int32), ("gj", gj, torch.int32),
                           ("cursor", cursor, torch.int64)):
        check("prefilter_dense", name, x, dtype, dev)
    rc, C = qexp_c.shape[0], tval.numel()
    if (qexp_c.dim() != 2 or qexp_c.shape[1] != KDIM or rc % ROW_TILE
            or rc == 0 or thr_c.numel() != rc or row_id.numel() != rc):
        raise ValueError(f"prefilter_dense: compacted rows must be [Rc, "
                         f"{KDIM}] with Rc a positive multiple of "
                         f"{ROW_TILE}, one threshold and row id each")
    if qexp_c.data_ptr() % 16:
        raise ValueError("prefilter_dense: compacted rows must be 16-byte "
                         "aligned")
    if C % TILE_T or C == 0 or C > 0x7fffffff:
        raise ValueError(f"prefilter_dense: tval length must be a positive "
                         f"multiple of {TILE_T} below 2^31")
    if max(offs) > MAX_OFFSET:
        raise ValueError(f"prefilter_dense: the kernel takes spaced offsets "
                         f"up to {MAX_OFFSET}")
    if letters.numel() < C + max(offs):
        raise ValueError("prefilter_dense: letters must cover every "
                         "position's k-mer")
    if gj.numel() != gi.numel() or cursor.numel() != 1:
        raise ValueError("prefilter_dense: gi and gj must pair up, and the "
                         "cursor must be one int64")


def prefilter_dense_hits(compacted, letters, tval, offsets, gi, gj,
                         cursor):
    """Every hit of one target chunk, the port of the TPU counts kernel
    and of the extraction after it: prefilter_dense_hits_plain's contract
    (compacted from compact_rows, letters and tval in the shared layout,
    gi and gj of equal length, cursor int64 [1]), with the hits in no
    fixed order on a card.

    On CUDA tensors this launches csrc/prefilter_dense.cu (the cursor
    zeroed first) and raises if the kernel cannot be built or launched;
    on CPU tensors it runs prefilter_dense_hits_plain."""
    offs = pad_offsets(offsets)
    if not on_card("prefilter_dense_hits", compacted[0]):
        return prefilter_dense_hits_plain(compacted, letters, tval, offsets,
                                          gi, gj, cursor)
    _check_inputs(compacted, letters, tval, offs, gi, gj, cursor)
    qexp_c, thr_c, row_id = compacted
    rc, C = qexp_c.shape[0], tval.numel()
    _HITS(qexp_c, thr_c, row_id, letters, tval, offs, rc, C // TILE_T, gi,
          gj, gi.numel(), cursor, cells=rc * C)


def chunk_hits(compacted, letters, tval, offsets, buffer):
    """(gi int32 [n], gj int64 [n]): the n hits of one target chunk
    (prefilter_dense_hits' inputs; gj relative to the chunk), in no fixed
    order, on the inputs' device: one pass into `buffer` (new_hit_buffer's
    form), one 8-byte read of its cursor, and the hits copied out of it.
    Where they overflow the buffer the chunk runs again into a buffer of
    exactly n hits (counted in dense_hit_reruns), so that the output never
    depends on the buffer's capacity."""
    gi, gj, cursor = buffer
    prefilter_dense_hits(compacted, letters, tval, offsets, gi, gj, cursor)
    n = int(cursor.item())
    if n <= gi.numel():
        return gi[:n].clone(), gj[:n].long()
    count("dense_hit_reruns")
    gi, gj, cursor = new_hit_buffer(n, gi.device)
    prefilter_dense_hits(compacted, letters, tval, offsets, gi, gj, cursor)
    again = int(cursor.item())
    if again != n:
        raise RuntimeError(f"chunk_hits: the pass found {n} hits, then "
                           f"{again}")
    return gi, gj.long()


def build_qexp_i8(batch: QueryKmerBatch, seed_scores: np.ndarray):
    """(qexp int8 [R, KDIM], thr int32 [R]) of a batch, R its row count
    rounded up to whole query tiles; pad rows never match."""
    if int(np.abs(seed_scores).max()) > 127:
        raise ValueError("the seed matrix exceeds the int8 range")
    R = max(-(-batch.n_rows // TILE_Q), 1) * TILE_Q
    qexp = np.zeros((R, KDIM), dtype=np.int8)     # build_qexp's, as int8
    s = seed_scores.astype(np.int8)
    n = batch.n_rows
    for p, off in enumerate(batch.offsets):
        qexp[:n, p * 21:(p + 1) * 21] = s[batch.q_flat[off:off + n]]
    thr = np.full(R, THR_INVALID, dtype=np.int32)
    thr[:batch.n_rows] = batch.kmer_thr
    return qexp, thr


class DenseTarget(NamedTuple):
    """The whole target of the dense pass on one device: letters uint8
    [t_res + TILE_T + span - 1], X past the target's end, so that every
    target chunk's k-mers lie inside; bval bool [t_res + TILE_T], the
    positions whose k-mer stays inside one ORF, False past the end;
    t_starts int64 [n_seqs + 1] (None where it was not given); t_res."""
    letters: torch.Tensor
    bval: torch.Tensor
    t_starts: Optional[torch.Tensor]
    t_res: int


def boundary_valid(t_starts: torch.Tensor, t_res: int, length: int,
                   kmer_span: int) -> torch.Tensor:
    """bool [length] on t_starts' device: target_boundary_valid of the
    target that t_starts delimits, False from t_res on (length > t_res)."""
    valid = torch.zeros(length, dtype=torch.bool, device=t_starts.device)
    valid[:t_res] = True
    s0, s1 = t_starts[:-1], t_starts[1:]
    for o in range(1, kmer_span):
        idx = s1 - o
        valid[torch.where(idx >= s0, idx, length - 1)] = False
    return valid


def dense_target(t_flat, t_bval, kmer_span: int, device,
                 t_starts=None) -> DenseTarget:
    """The DenseTarget of t_flat on `device`: the letters in one upload;
    bval from t_bval (a host mask or a tensor, its first t_res entries),
    or, where t_bval is None, built on the device from t_starts
    (boundary_valid) in the span dense_target_valid."""
    dev = torch.device(device)
    t_flat = np.asarray(t_flat)
    t_res = len(t_flat)
    if t_res and int(t_flat.max()) > X_IDX:
        raise ValueError("target letters must lie in [0, 20]")
    letters = np.full(t_res + TILE_T + kmer_span - 1, X_IDX, dtype=np.uint8)
    letters[:t_res] = t_flat
    ts = (None if t_starts is None
          else upload(np.array(t_starts, dtype=np.int64), dev))
    if t_bval is None:
        with span("dense_target_valid"):
            bval = boundary_valid(ts, t_res, t_res + TILE_T, kmer_span)
    else:
        bval = torch.zeros(t_res + TILE_T, dtype=torch.bool, device=dev)
        bval[:t_res] = upload(t_bval, dev)[:t_res]
    return DenseTarget(upload(letters, dev), bval, ts, t_res)


def target_chunk(target: DenseTarget, batch: QueryKmerBatch, diag21,
                 kmer_thr: int, c0: int, C: int):
    """(letters, tval) of target positions c0 .. c0 + C - 1: a slice of
    the target on its device, and tval from prep (diag21 the seed
    matrix's diagonal there). C is a multiple of TILE_T and c0 + C at
    most a tile past the target's end."""
    letters = target.letters[c0:c0 + C + batch.span - 1]
    return letters, prep(letters, target.bval[c0:c0 + C], diag21,
                         tuple(int(o) for o in batch.offsets),
                         int(kmer_thr))


def _diag21(seed_scores, device):
    return upload(np.diag(seed_scores)[:21].astype(np.int32), device)


def dense_inputs(batch: QueryKmerBatch, t_flat: np.ndarray,
                 t_bval: np.ndarray, seed_scores: np.ndarray, kmer_thr: int,
                 device):
    """(qexp, thr, letters, tval, offsets): the kernels' inputs (the
    shared layout) for one chunk holding the batch and the whole
    target, on `device`."""
    qexp, thr = build_qexp_i8(batch, seed_scores)
    target = dense_target(t_flat, t_bval, batch.span, device)
    C = max(-(-target.t_res // TILE_T), 1) * TILE_T
    letters, tval = target_chunk(target, batch, _diag21(seed_scores, device),
                                 kmer_thr, 0, C)
    return (upload(qexp, device), upload(thr, device), letters, tval,
            tuple(int(o) for o in batch.offsets))


def match_pairs(batch: QueryKmerBatch, t_flat: np.ndarray,
                t_bval: np.ndarray, seed_scores: np.ndarray, kmer_thr: int,
                device="cuda", target: Optional[DenseTarget] = None):
    """(gi int32, gj int64) tensors on `device`: every query k-mer row gi
    of the batch and target position gj with K >= thr_gi and a valid
    k-mer at gj, found by one pass per target chunk (chunk_hits: the
    kernel on a GPU, its plain version on the CPU) into the device's hit
    buffer (hit_buffer). Hits come in no fixed order and stay on the
    device; no pad row or position past the target hits (their
    thresholds and tval exclude them), and the stream rebuild drops any
    that would. target: the DenseTarget of (t_flat, t_bval) already on
    `device` (a resident copy of the catalog), or None to upload it here.
    Each target chunk, of at most MAX_CHUNK positions, is a slice of it;
    the last ends a tile past the target at most."""
    dev = torch.device(device)
    if target is None:
        target = dense_target(t_flat, t_bval, batch.span, dev)
    t_res = target.t_res
    offsets = tuple(int(o) for o in batch.offsets)
    qexp_np, thr_np = build_qexp_i8(batch, seed_scores)
    rows = int(np.count_nonzero(thr_np <= MAX_K))
    count("dense_rows", rows)
    count("dense_cells", rows * t_res)
    # the kernel's compacted rows, once for every target chunk
    compacted = compact_rows(upload(qexp_np, dev), upload(thr_np, dev))
    C = min(max(MAX_CHUNK // TILE_T, 1) * TILE_T,
            max(-(-t_res // TILE_T), 1) * TILE_T)
    diag21 = _diag21(seed_scores, dev)
    buffer = hit_buffer(dev)
    gis, gjs = [], []
    for c0 in range(0, t_res, C):
        with span("dense_target"):
            letters, tval = target_chunk(
                target, batch, diag21, kmer_thr, c0,
                min(C, -(-(t_res - c0) // TILE_T) * TILE_T))
        with span("dense_counts"):
            gi, gj = chunk_hits(compacted, letters, tval, offsets, buffer)
        count("dense_hits", gi.numel())
        if c0:
            gj += c0
        gis.append(gi)
        gjs.append(gj)
    if not gis:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev))
    if len(gis) == 1:
        return gis[0], gjs[0]
    return torch.cat(gis), torch.cat(gjs)


# ---------------------------------------------------------------------------
# reference-order match streams (csrc/prefilter_streams.cu) + finalize
# ---------------------------------------------------------------------------
#
# The reference's postings walk emits a query's matches in a fixed order,
# and the dup filter downstream depends on it: k-mer position ascending,
# then KmerGenerator enumeration order, (half-1 rank, half-2 rank) under
# each half list's (score desc, code asc) sort (KmerGenerator.cpp:186-),
# then target sequence ascending; one entry per (code, seq) at its first
# target position (IndexTable.h:341- unique-insert). The dense hits are
# put in that order in four steps, each a kernel wrapper (a hand-written
# kernel on CUDA tensors, its plain PyTorch version on CPU tensors):
#
#   stream_rank_tables  the rank of every target half-code under each
#                       query half of the hit rows;
#   stream_keys         each hit's sort key (row, rank 1, rank 2, target
#                       sequence) and its position in the sequence;
#   sort_keys           the sort (torch.sort, CUB's radix sort on a card),
#                       which returns the sorted keys beside the order;
#   stream_runs         each run of one key kept at its least position:
#                       the flat streams (m_t, m_d) and each query key's
#                       first entry.
#
# The JAX package did this on the host with numpy (its hits_to_streams);
# no TPU kernel computes it.

N_QUERY_HALVES = (X_IDX + 1) ** 3   # base-21 codes of a query half, X in
N_HALF = 20 ** 3                    # codes of a target half (letters < 20)
# distinct query halves whose rank tables the plain version sorts at once
# (2,048 x 8,000 int64 sort indices: 131 MB)
RANK_CHUNK = 2048
# bits of the one sort key (row, rank 1, rank 2, target sequence); wider
# keys sort in two stable passes (target sequence, then the rest)
KEY_BITS = 63

RUN_TILE = 4096      # sorted hits per block of the run kernels

# Each stream wrapper's calls that launched its kernels count in the
# registry as prefilter_streams_{ranks,keys,runs}_launches (the plain
# versions count in none of them).
_STREAMS = {"prefilter_streams_query_halves": N_QUERY_HALVES,
            "prefilter_streams_target_halves": N_HALF,
            "prefilter_streams_run_tile": RUN_TILE}
_HALVES = Entry("prefilter_streams", "prefilter_streams_halves",
                (PTR, I64, I64, PTR, INTS, PTR, PTR, PTR, PTR),
                counter="prefilter_streams_ranks", constants=_STREAMS)
_TABLES = Entry("prefilter_streams", "prefilter_streams_tables",
                (PTR, INT, PTR, INT, PTR), constants=_STREAMS)
_KEYS = Entry("prefilter_streams", "prefilter_streams_keys",
              (PTR, PTR, I64, I64, PTR, INTS, PTR, I64, PTR, INT, PTR, PTR,
               INT, INT, PTR, PTR, PTR, PTR),
              counter="prefilter_streams_keys", constants=_STREAMS)
_RUNS = Entry("prefilter_streams", "prefilter_streams_runs",
              (PTR, PTR, PTR, PTR, PTR, I64, INT, PTR, INT, PTR, PTR, PTR,
               PTR, PTR), counter="prefilter_streams_runs",
              constants=_STREAMS)


def query_halves(q_flat, offsets, rows):
    """(h1, h2) int64: the base-21 codes (X included) of the two query
    halves, letters at offsets 0-2 and 3-5, of each row in `rows`."""
    out = []
    for h in range(2):
        code = torch.zeros(rows.numel(), dtype=torch.int64,
                           device=rows.device)
        for p in range(3):
            code = code * (X_IDX + 1) + q_flat[rows + offsets[3 * h + p]].long()
        out.append(code)
    return out


def stream_rank_tables_plain(q_flat, offsets, gi, n_rows: int, seed):
    """Plain PyTorch version of the rank-table kernels: (slot_of int32
    [N_QUERY_HALVES], tables int16 [n_uniq, N_HALF]). The query halves
    of the hit rows (gi < n_rows) are numbered in ascending code
    (slot_of, -1 where absent); tables[slot_of[q], c] is the rank of
    target half-code c under half q by (score desc, code asc), the score
    S[q0][c0] + S[q1][c1] + S[q2][c2] of the seed matrix S (int32 [A,
    A]). Built RANK_CHUNK halves at a time."""
    dev = gi.device
    rows = gi[(gi >= 0) & (gi < n_rows)].long()
    present = torch.zeros(N_QUERY_HALVES, dtype=torch.bool, device=dev)
    for code in query_halves(q_flat, offsets, rows):
        present[code] = True
    uniq = torch.nonzero(present).flatten()
    slot_of = torch.full((N_QUERY_HALVES,), -1, dtype=torch.int32,
                         device=dev)
    slot_of[uniq] = torch.arange(uniq.numel(), dtype=torch.int32,
                                 device=dev)
    c = torch.arange(N_HALF, device=dev)
    cols = (c // 400, c // 20 % 20, c % 20)
    ranks = torch.arange(N_HALF, dtype=torch.int16, device=dev)
    tables = torch.empty((uniq.numel(), N_HALF), dtype=torch.int16,
                         device=dev)
    base = X_IDX + 1
    for lo in range(0, uniq.numel(), RANK_CHUNK):
        u = uniq[lo:lo + RANK_CHUNK]
        halves = (u // (base * base), u // base % base, u % base)
        score = sum(seed[h][:, col] for h, col in zip(halves, cols))
        order = torch.sort(-score, dim=1, stable=True).indices
        tables[lo:lo + u.numel()].scatter_(1, order,
                                           ranks.expand(u.numel(), -1))
    return slot_of, tables


def stream_keys_plain(gi, gj, q_flat, offsets, n_rows: int, t_flat,
                      t_starts, slot_of, tables, seq_bits: int, narrow: bool):
    """Plain PyTorch version of the key kernel: (key int64, tseq int32,
    tpos int32, each [n]; bad int32 [1]). A kept hit (gi < n_rows, gj <
    t_res) gets row_code = (gi * N_HALF + r1) * N_HALF + r2 from its
    target half-codes' ranks, its target sequence and its position
    there, and key = row_code << seq_bits | tseq when `narrow`, else
    row_code; the others get key -1. bad counts kept hits whose k-mer
    holds an X or runs past the target (they get key -1 too)."""
    dev = gi.device
    n = gi.numel()
    key = torch.full((n,), -1, dtype=torch.int64, device=dev)
    tseq = torch.zeros(n, dtype=torch.int32, device=dev)
    tpos = torch.zeros(n, dtype=torch.int32, device=dev)
    g, j = gi.long(), gj.long()
    t_res = t_flat.numel()
    idx = torch.nonzero((g >= 0) & (g < n_rows) & (j >= 0)
                        & (j < t_res)).flatten()
    at = j[idx, None] + torch.tensor(offsets, device=dev)[None, :]
    inside = at < t_res
    letters = torch.where(inside, t_flat[at.clamp(max=max(t_res - 1, 0))]
                          .long(), X_IDX)
    ok = (letters < 20).all(dim=1)
    bad = (~ok).sum().to(torch.int32).reshape(1)
    idx, letters = idx[ok], letters[ok]
    rows, jj = g[idx], j[idx]
    c1 = letters[:, 0] * 400 + letters[:, 1] * 20 + letters[:, 2]
    c2 = letters[:, 3] * 400 + letters[:, 4] * 20 + letters[:, 5]
    h1, h2 = query_halves(q_flat, offsets, rows)
    r1 = tables[slot_of[h1].long(), c1].long()
    r2 = tables[slot_of[h2].long(), c2].long()
    s = torch.searchsorted(t_starts, jj, right=True) - 1
    row_code = (rows * N_HALF + r1) * N_HALF + r2
    key[idx] = (row_code << seq_bits) | s if narrow else row_code
    tseq[idx] = s.to(torch.int32)
    tpos[idx] = (jj - t_starts[s]).to(torch.int32)
    return key, tseq, tpos, bad


def sort_keys(key, tseq, narrow: bool):
    """(perm int64 [n], sorted_key int64 [n]): the permutation that orders
    the hits by (key, tseq), kept hits (key >= 0) after the dropped ones,
    and the keys in that order (key[perm]): one sort of the packed key
    when `narrow`, else a stable sort by tseq then a stable sort by key.
    torch.sort (CUB's radix sort on a card)."""
    if narrow:
        sorted_key, perm = torch.sort(key, stable=True)
        return perm, sorted_key
    first = torch.sort(tseq, stable=True).indices
    sorted_key, second = torch.sort(key[first], stable=True)
    return first[second], sorted_key


def stream_runs_plain(perm, key, tseq, tpos, gi, q_starts, n_keys: int):
    """Plain PyTorch version of the run kernels: (m_t int32, m_d uint16,
    bounds int64 [n_keys + 1], n_runs int64 [1]). Over the hits in sorted
    order (perm), each run of kept hits with one (key, tseq) gives one
    stream entry: m_t = tseq and m_d = (gi - q_starts[query key of gi] -
    least tpos of the run) & 0xFFFF; bounds[k] is query key k's first
    entry (entries are in key order)."""
    dev = perm.device
    k, s = key[perm], tseq[perm]
    kept = k >= 0
    first = kept.clone()
    first[1:] &= (k[1:] != k[:-1]) | (s[1:] != s[:-1])
    n_runs = int(first.sum())
    run = torch.cumsum(first, 0) - 1
    pos = torch.full((n_runs,), 2 ** 31 - 1, dtype=torch.int32,
                     device=dev).scatter_reduce(0, run[kept],
                                                tpos[perm][kept], "amin")
    head = perm[first]
    g = gi[head].long()
    of_key = torch.searchsorted(q_starts, g, right=True) - 1
    m_d = ((g - q_starts[of_key] - pos) & 0xFFFF).to(torch.uint16)
    bounds = torch.searchsorted(of_key, torch.arange(n_keys + 1, device=dev))
    return (tseq[head], m_d, bounds,
            torch.tensor([n_runs], dtype=torch.int64, device=dev))


def stream_rank_tables(q_flat, offsets, gi, n_rows: int, seed):
    """(slot_of int32 [N_QUERY_HALVES], tables int16 [n_uniq, N_HALF]):
    the rank tables of the hit rows' query halves (stream_rank_tables_plain
    says what they hold). q_flat uint8 [n_rows + span - 1], offsets the 6
    spaced offsets, gi int32 [n], seed int32 [A, A] (|S| <= 127, A >= 21).

    On CUDA tensors this launches csrc/prefilter_streams.cu's
    mark_halves_kernel and slots_kernel, reads the number of halves, and
    launches rank_tables_kernel (one block of 256 threads per half); it
    raises if a kernel cannot be built or launched. On CPU tensors it
    runs stream_rank_tables_plain."""
    if not on_card("stream_rank_tables", gi):
        return stream_rank_tables_plain(q_flat, offsets, gi, n_rows, seed)
    dev = gi.device
    for name, x, dtype in (("gi", gi, torch.int32),
                           ("q_flat", q_flat, torch.uint8),
                           ("seed", seed, torch.int32)):
        check("stream_rank_tables", name, x, dtype, dev)
    if (seed.dim() != 2 or seed.shape[0] != seed.shape[1]
            or seed.shape[0] <= X_IDX or int(seed.abs().max()) > 127):
        raise ValueError("stream_rank_tables: the seed matrix must be "
                         "square, at least 21 wide, within [-127, 127]")
    present = torch.zeros(-(-N_QUERY_HALVES // 32), dtype=torch.int32,
                          device=dev)                   # a bitmap
    slot_of = torch.empty(N_QUERY_HALVES, dtype=torch.int32, device=dev)
    uniq = torch.empty(N_QUERY_HALVES, dtype=torch.int32, device=dev)
    n_uniq = torch.empty(1, dtype=torch.int32, device=dev)
    _HALVES(gi, gi.numel(), n_rows, q_flat, pad_offsets(offsets), present,
            slot_of, uniq, n_uniq)
    n_u = int(n_uniq.item())
    tables = torch.empty((n_u, N_HALF), dtype=torch.int16, device=dev)
    _TABLES(uniq, n_u, seed, seed.shape[1], tables)
    return slot_of, tables


def stream_keys(gi, gj, q_flat, offsets, n_rows: int, t_flat, t_starts,
                slot_of, tables, seq_bits: int, narrow: bool):
    """(key int64, tseq int32, tpos int32, each [n]; bad int32 [1]): each
    hit's sort key, target sequence and position (stream_keys_plain says
    how). gi int32 [n], gj int64 [n], q_flat uint8, t_flat uint8 [t_res],
    t_starts int64 [n_seqs + 1], slot_of and tables from
    stream_rank_tables.

    On CUDA tensors this launches csrc/prefilter_streams.cu's keys_kernel
    (one thread per hit) and raises if it cannot be built or launched; on
    CPU tensors it runs stream_keys_plain."""
    if not on_card("stream_keys", gi):
        return stream_keys_plain(gi, gj, q_flat, offsets, n_rows, t_flat,
                                 t_starts, slot_of, tables, seq_bits, narrow)
    dev = gi.device
    for name, x, dtype in (("gi", gi, torch.int32), ("gj", gj, torch.int64),
                           ("q_flat", q_flat, torch.uint8),
                           ("t_flat", t_flat, torch.uint8),
                           ("t_starts", t_starts, torch.int64),
                           ("slot_of", slot_of, torch.int32),
                           ("tables", tables, torch.int16)):
        check("stream_keys", name, x, dtype, dev)
    n = gi.numel()
    if gj.numel() != n or t_starts.numel() - 1 > 0x7fffffff:
        raise ValueError("stream_keys: gi and gj must pair up, and the "
                         "sequences must be countable in int32")
    key = torch.empty(n, dtype=torch.int64, device=dev)
    tseq = torch.empty(n, dtype=torch.int32, device=dev)
    tpos = torch.empty(n, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    _KEYS(gi, gj, n, n_rows, q_flat, pad_offsets(offsets), t_flat,
          t_flat.numel(), t_starts, t_starts.numel() - 1, slot_of, tables,
          seq_bits, int(narrow), key, tseq, tpos, bad)
    return key, tseq, tpos, bad


def stream_runs(perm, key, tseq, tpos, gi, q_starts, n_keys: int,
                sorted_key, seq_bits: int, narrow: bool):
    """(m_t int32, m_d uint16, bounds int64 [n_keys + 1], n_runs int64
    [1]): the stream entries of the sorted hits (stream_runs_plain says
    what they hold); on a card m_t and m_d hold n entries, the first
    n_runs written. perm int64 [n] and sorted_key (key[perm]) from
    sort_keys, key/tseq/tpos from stream_keys, gi int32 [n], q_starts
    int64 [n_keys + 1]; seq_bits and narrow the keys' packing, as
    stream_keys took it: packed keys give the kernels each hit's row and
    sequence, else they read them through perm.

    On CUDA tensors this launches csrc/prefilter_streams.cu's
    run_count_kernel and run_write_kernel and raises if they cannot be
    built or launched; on CPU tensors it runs stream_runs_plain."""
    if not on_card("stream_runs", perm):
        return stream_runs_plain(perm, key, tseq, tpos, gi, q_starts, n_keys)
    dev = perm.device
    for name, x, dtype in (("perm", perm, torch.int64),
                           ("key", key, torch.int64),
                           ("sorted_key", sorted_key, torch.int64),
                           ("tseq", tseq, torch.int32),
                           ("tpos", tpos, torch.int32),
                           ("gi", gi, torch.int32),
                           ("q_starts", q_starts, torch.int64)):
        check("stream_runs", name, x, dtype, dev)
    n = perm.numel()
    if not (key.numel() == sorted_key.numel() == tseq.numel() == tpos.numel()
            == gi.numel() == n and q_starts.numel() == n_keys + 1
            and 0 < n_keys < 2 ** 31
            and (not narrow or 0 <= seq_bits < KEY_BITS)):
        raise ValueError("stream_runs: one key, sorted key, sequence, "
                         "position and row per hit, one start per query "
                         "key and its end, and a packing inside the key")
    nb = max(-(-n // RUN_TILE), 1)
    block_off = torch.empty(nb + 1, dtype=torch.int64, device=dev)
    m_t = torch.empty(n, dtype=torch.int32, device=dev)
    m_d = torch.empty(n, dtype=torch.uint16, device=dev)
    n_runs = torch.empty(1, dtype=torch.int64, device=dev)
    bounds = torch.empty(n_keys + 1, dtype=torch.int64, device=dev)
    _RUNS(sorted_key, perm, tseq, tpos, gi, n, seq_bits if narrow else -1,
          q_starts, n_keys, block_off, m_t, m_d, n_runs, bounds)
    return m_t, m_d, bounds, n_runs


def stream_inputs(batch: QueryKmerBatch, t_flat, t_starts, seed_scores,
                  device, target: Optional[DenseTarget] = None):
    """The stream wrappers' inputs from host data, on `device`: (q_flat,
    offsets, t_flat, t_starts, seed, q_starts, seq_bits, narrow). narrow:
    the packed key of any row of the batch fits KEY_BITS. target: the
    DenseTarget of (t_flat, t_starts) on `device`, whose letters and
    starts are read in place of an upload of t_flat and t_starts."""
    dev = torch.device(device)
    offsets = tuple(int(o) for o in batch.offsets)
    if len(offsets) != N_OFF:
        raise ValueError(f"the match streams take {N_OFF} offsets (two "
                         f"halves of 3)")
    n_seqs = len(t_starts) - 1
    seq_bits = max(n_seqs - 1, 1).bit_length()
    narrow = ((batch.n_rows * N_HALF * N_HALF - 1).bit_length() + seq_bits
              <= KEY_BITS)

    def put(x, dtype):     # a copy: the masked target may be read-only
        return upload(np.array(x, dtype=dtype), dev)

    if target is None:
        t, ts = put(t_flat, np.uint8), put(t_starts, np.int64)
    else:
        t, ts = target.letters[:target.t_res], target.t_starts
    return (put(batch.q_flat, np.uint8), offsets, t, ts,
            put(seed_scores, np.int32), put(batch.q_starts, np.int64),
            seq_bits, narrow)


def rebuild_streams(batch: QueryKmerBatch, gi, gj, t_flat, t_starts,
                    seed_scores, target: Optional[DenseTarget] = None):
    """(m_t int32, m_d uint16, key_offsets int64 [len(batch.keys) + 1])
    numpy: the reference-order match streams of the batch's keys from its
    dense hits gi (int32) and gj (int64), tensors on one device: the
    kernels on a card, their plain versions on the CPU. Key k's stream
    is m_t / m_d[key_offsets[k]:key_offsets[k + 1]]. One read-back: the
    count of entries (and of unrankable hits: raises), then the arrays.
    target: as stream_inputs takes it."""
    n_keys = len(batch.keys)
    if n_keys == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.uint16),
                np.zeros(1, np.int64))
    q_flat, offsets, t, ts, seed, qs, seq_bits, narrow = stream_inputs(
        batch, t_flat, t_starts, seed_scores, gi.device, target)
    slot_of, tables = stream_rank_tables(q_flat, offsets, gi, batch.n_rows,
                                         seed)
    key, tseq, tpos, bad = stream_keys(gi, gj, q_flat, offsets, batch.n_rows,
                                       t, ts, slot_of, tables, seq_bits,
                                       narrow)
    perm, sorted_key = sort_keys(key, tseq, narrow)
    m_t, m_d, bounds, n_runs = stream_runs(perm, key, tseq, tpos, gi, qs,
                                           n_keys, sorted_key, seq_bits,
                                           narrow)
    n_bad, n = torch.cat([bad.long(), n_runs]).tolist()
    count("stream_matches", n)
    if n_bad:
        raise RuntimeError(f"rebuild_streams: {n_bad} hits whose k-mer holds "
                           f"an X or runs past the target")
    return m_t[:n].cpu().numpy(), m_d[:n].cpu().numpy(), bounds.cpu().numpy()


def hits_to_streams(batch: QueryKmerBatch, gi, gj, t_flat, t_starts,
                    enumerator) -> dict:
    """{key: (m_t, m_d)} int64 numpy: the (gi, gj) hits' match streams
    per query key in the reference's exact emission order (the comment
    above N_QUERY_HALVES), by the plain versions on the CPU from
    enumerator's seed matrix: the JAX package's hits_to_streams."""
    m_t, m_d, bounds = rebuild_streams(
        batch, torch.from_numpy(np.asarray(gi, dtype=np.int32)),
        torch.from_numpy(np.asarray(gj, dtype=np.int64)), t_flat,
        t_starts, enumerator.s80)
    return {k: (m_t[bounds[i]:bounds[i + 1]].astype(np.int64),
                m_d[bounds[i]:bounds[i + 1]].astype(np.int64))
            for i, k in enumerate(batch.keys)}


def composition_bias(q_flat, q_starts, seed_m, comp_bias_corr: bool):
    """float64 [len(q_flat)]: every query's local composition bias
    (ops/bias.py::local_aa_bias, bit for bit; zeros when comp_bias_corr
    is off), query i's at q_starts[i]:q_starts[i + 1], by one native call
    (local_bias_batch), or by local_aa_bias_batch without the native
    library."""
    from .bias import expected_score_tab, local_aa_bias_batch
    from ..native import get_lib
    if not comp_bias_corr:
        return np.zeros(len(q_flat), dtype=np.float64)
    lib = get_lib()
    if lib is None:
        rows = [q_flat[q_starts[i]:q_starts[i + 1]]
                for i in range(len(q_starts) - 1)]
        return np.concatenate([np.zeros(0)]
                              + local_aa_bias_batch(rows, seed_m))
    q8 = np.ascontiguousarray(q_flat, dtype=np.uint8)
    qs = np.ascontiguousarray(q_starts, dtype=np.int64)
    seed32 = np.ascontiguousarray(seed_m.scores, dtype=np.int32)
    etab = np.ascontiguousarray(expected_score_tab(seed_m))
    out = np.empty(len(q8), dtype=np.float64)
    lib.local_bias_batch(q8.ctypes.data, qs.ctypes.data, len(qs) - 1,
                         seed32.ctypes.data, seed32.shape[1],
                         etab.ctypes.data, 1, out.ctypes.data)
    return out


def finalize_streams(m_t, m_d, key_off, q_flat, q_starts, bias, t_flat,
                     t_starts, params, ungapped_m):
    """(targets int32, scores int32, diagonals int32, offsets int64
    [n_keys + 1]): the dup filter, ungapped diagonal rescore and max_seqs
    selection of every key's match stream (key i's: m_t /
    m_d[key_off[i]:key_off[i + 1]]; its letters and composition bias at
    q_starts[i]:q_starts[i + 1] of q_flat and bias), in one threaded
    native call (prefilter_finalize_batch). Raises if the native library
    is missing or fails."""
    from .prefilter import _bin_bits
    from ..native import get_lib
    lib = get_lib()
    if lib is None:
        raise RuntimeError("finalize_streams: the native library is not "
                           "available")
    n_keys = len(key_off) - 1
    q8 = np.ascontiguousarray(q_flat, dtype=np.uint8)
    qs = np.ascontiguousarray(q_starts, dtype=np.int64)
    bias = np.ascontiguousarray(bias, dtype=np.float64)
    ung32 = np.ascontiguousarray(ungapped_m.scores, dtype=np.int32)
    m_t = np.ascontiguousarray(m_t, dtype=np.int32)
    m_d = np.ascontiguousarray(m_d, dtype=np.uint16)
    key_off = np.ascontiguousarray(key_off, dtype=np.int64)
    t_flat = np.ascontiguousarray(t_flat, dtype=np.uint8)
    t_starts = np.ascontiguousarray(t_starts, dtype=np.int64)
    n_targets = len(t_starts) - 1
    total = lib.prefilter_finalize_batch(
        m_t.ctypes.data, m_d.ctypes.data, key_off.ctypes.data, n_keys,
        q8.ctypes.data, qs.ctypes.data, bias.ctypes.data,
        ung32.ctypes.data, ung32.shape[1], abs(int(ung32.min())),
        t_flat.ctypes.data, t_starts.ctypes.data, n_targets,
        params.min_diag_score, params.max_seqs, _bin_bits(n_targets))
    if total < 0:
        lib.prefilter_batch_free()
        raise RuntimeError("prefilter_finalize_batch failed")
    out_t = np.empty(total + 1, dtype=np.int32)
    out_s = np.empty(total + 1, dtype=np.int32)
    out_d = np.empty(total + 1, dtype=np.int32)
    out_off = np.empty(n_keys + 1, dtype=np.int64)
    lib.prefilter_batch_fetch(out_t.ctypes.data, out_s.ctypes.data,
                              out_d.ctypes.data, out_off.ctypes.data)
    return out_t[:total], out_s[:total], out_d[:total], out_off


def finalize_streams_plain(m_t, m_d, key_off, q_flat, q_starts, bias,
                           t_flat, t_starts, params, ungapped_m):
    """finalize_streams key by key in Python (prefilter._finalize_py), for
    the CPU route where the native library is absent."""
    from .prefilter import _finalize_py, ungapped_profile_cap
    index = _MaskedTargets(np.asarray(t_flat), np.asarray(t_starts))
    hits = []
    for i in range(len(key_off) - 1):
        lo, hi = int(key_off[i]), int(key_off[i + 1])
        if lo == hi:
            hits.append([])
            continue
        q0, q1 = int(q_starts[i]), int(q_starts[i + 1])
        q_num = np.asarray(q_flat[q0:q1], dtype=np.int64)
        profile, cap = ungapped_profile_cap(q_num, bias[q0:q1], ungapped_m)
        hits.append(_finalize_py(m_t[lo:hi].astype(np.int64),
                                 m_d[lo:hi].astype(np.int64), index,
                                 profile, cap, params, q_num))
    off = np.zeros(len(hits) + 1, dtype=np.int64)
    np.cumsum([len(h) for h in hits], out=off[1:])
    flat = [h for hl in hits for h in hl]
    return (np.array([h.target for h in flat], dtype=np.int32),
            np.array([h.score for h in flat], dtype=np.int32),
            np.array([h.diagonal for h in flat], dtype=np.int32), off)


class _MaskedTargets:
    """What _finalize_py reads of a TargetIndex: the masked sequences
    (views into the flat target) and their count."""

    def __init__(self, flat, starts):
        self.seqs_masked = [flat[starts[i]:starts[i + 1]]
                            for i in range(len(starts) - 1)]
        self.seq_lengths = np.diff(starts)


def device_prefilter_arrays(q_all, keys, bias80_all, t_flat_masked,
                            t_starts, params, seed_m, ungapped_m,
                            device="cuda", catalog=None):
    """(targets int32, scores int32, diagonals int32, offsets int64
    [len(keys) + 1]): the dense prefilter's hits of every key, the
    contract of prefilter_query_batch(as_arrays=True) and byte-identical
    to it. bias80_all[k] is key k's composition bias; None computes it
    here in one native call (composition_bias). The dense pass and the
    stream rebuild run on `device` (the kernels on a card, their plain
    versions on the CPU); one read-back per key chunk brings the flat
    streams to the host, and one threaded native call finalizes every
    key. Without the native library only the CPU route runs, key by key
    (finalize_streams_plain).

    catalog: the SetDB whose masked target t_flat_masked is; its
    DenseTarget on `device` is then kept in the process's resident store
    (ops/resident.py) under the SetDB, the mask's parameters and the
    pattern span, built on the first search and read in place on every
    later one. Without it the target goes to `device` for this call.

    Its steps run in the spans dense_target_valid (inside a build of the
    target: the positions whose k-mer stays inside one ORF),
    dense_query_batch (the query batch, its composition bias), dense_match
    (match_pairs: each target chunk's slice and tval in dense_target, the
    pass that finds its hits, and the read-back of their number, in
    dense_counts), dense_streams (the stream rebuild and its read-back)
    and dense_finalize."""
    from ..native import get_lib
    t_flat_masked = np.ascontiguousarray(t_flat_masked, dtype=np.uint8)
    t_starts = np.asarray(t_starts, dtype=np.int64)
    if get_lib() is None and torch.device(device).type != "cpu":
        raise RuntimeError("the dense prefilter on a card needs the native "
                           "library (its batch finalize)")
    kmer_thr = params.kmer_threshold()

    def build():
        return dense_target(t_flat_masked, None, params.pattern_span, device,
                            t_starts=t_starts)

    if catalog is None:
        target = build()
    else:
        from . import resident
        target = resident.get(catalog, ("dense", bool(params.mask),
                                        params.seed_matrix,
                                        params.pattern_span), device, build)
        if (target.t_res != len(t_flat_masked)
                or target.t_starts.numel() != len(t_starts)):
            raise RuntimeError("device_prefilter_arrays: the catalog's "
                               "resident target differs from the masked "
                               "target given")
    with span("dense_query_batch"):
        q_flat, q_starts = flat_keys(q_all, keys, np.uint8)
        if bias80_all is None:
            bias = composition_bias(q_flat, q_starts, seed_m,
                                    params.comp_bias_corr)
            bias80_all = {k: bias[q_starts[i]:q_starts[i + 1]]
                          for i, k in enumerate(keys)}
        else:
            bias = flat_keys(bias80_all, keys, np.float64)[0]

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

    m_ts, m_ds, offs = [], [], [np.zeros(1, np.int64)]
    for kchunk in key_chunks:
        with span("dense_query_batch"):
            batch = build_query_batch(q_all, kchunk, bias80_all, params)
        with span("dense_match"):
            gi, gj = match_pairs(batch, t_flat_masked, target.bval,
                                 seed_m.scores, kmer_thr, device=device,
                                 target=target)
        with span("dense_streams"):
            m_t, m_d, bounds = rebuild_streams(batch, gi, gj, t_flat_masked,
                                               t_starts, seed_m.scores,
                                               target=target)
        offs.append(bounds[1:] + offs[-1][-1])
        m_ts.append(m_t)
        m_ds.append(m_d)
    finalize = finalize_streams if get_lib() is not None \
        else finalize_streams_plain
    with span("dense_finalize"):
        return finalize(np.concatenate(m_ts), np.concatenate(m_ds),
                        np.concatenate(offs), q_flat, q_starts, bias,
                        t_flat_masked, t_starts, params, ungapped_m)


def device_prefilter(q_all, keys, bias80_all, t_flat_masked, t_starts,
                     params, enumerator, seed_m, ungapped_m,
                     device="cuda") -> dict:
    """{key: [PrefilterHit]} of device_prefilter_arrays, byte-identical to
    prefilter_query, in the JAX package's signature (the rank tables come
    from seed_m; enumerator is not read)."""
    from .prefilter import PrefilterHit
    t, s, d, off = device_prefilter_arrays(
        q_all, keys, bias80_all, t_flat_masked, t_starts, params, seed_m,
        ungapped_m, device=device)
    return {k: [PrefilterHit(int(t[i]), int(s[i]), int(d[i]))
                for i in range(off[n], off[n + 1])]
            for n, k in enumerate(keys)}
