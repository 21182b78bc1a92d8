"""Dense all-pairs Smith-Waterman scores on the GPU (kernels B3 and B4).

The port of spacepharer_tpu/ops/sw_pallas.py. Its two Pallas kernels,
one query against every target (_sw_kernel) and a (query tile, target
tile) grid (_sw_kernel_batch), compute one function, the per-shard
scorer of the device mesh (parallel/sharding.py::sw_score_allpairs):

  q_prof int32 [Q, LQ, A]  per-position query profiles, pad entries NEG
  q_len  int32 [Q]         rows j >= q_len are masked out
  t_seqs int32 [LT, T]     target letters, transposed
  t_len  int32 [T]         columns i >= t_len change nothing
  ->     int32 [Q, T]      best local scores (Farrar E-from-pre-F, floored
                           at 0), cell for cell ops.align._forward_pass

Here both are entries of one CUDA kernel (csrc/sw_dense.cu): sw_scores_batch
(B4), which the mesh calls, and sw_scores_one_query (B3, Q = 1), which, as
in the JAX package, no product path calls. On CPU tensors the wrappers run
the plain PyTorch column scan beside them. They take any Q and T: the
TPU's multiples of 8 queries and 256 targets were its tile layout. A
letter outside [0, A) scores 0, as the TPU kernels' one-hot product gives
it. The one-hot MXU gather and the log2 shift-max cummax have no
counterpart on the card.

The kernel takes the targets packed (pack_targets, on their device) in
kernel B1's layout (ops/sw_packed.py::pack_runs): uint8 runs, longest
target first, each 16-aligned and padded to a multiple of 16; a letter
outside [0, A) is stored as A (the profile's zero column) and a pad
letter as A + 1 (a column of NEG). The mesh packs each target block once
and calls sw_scores_packed; sw_scores_packed_plain runs the plain scan
through the same packing, pad letters included.
"""
from dataclasses import dataclass

import numpy as np
import torch

from ._cuda import I64, INT, PTR, Entry, check, on_card
from .sw_packed import T_ALIGN, pack_runs, scratch_slots

NEG = -(10 ** 6)
STRIPE = 16                 # query rows per register stripe (csrc/sw_dense.cu)
MAX_ALPHA = 128             # profile columns a launch may have (sw_dense.cu)
SCRATCH_BYTES = 1 << 31     # stripe-boundary scratch per launch
PLAIN_MAX_ELEMS = 1 << 26   # DP-state elements per target run (plain)

# The two wrappers count their kernel launches in the registry
# (logging.count) as sw_dense_one_query_launches and
# sw_dense_batch_launches, and the true DP cells (query rows < q_len x
# target columns < t_len) they scored in sw_dense_cells; the plain CPU
# path counts in none of them.
_SIGNATURE = (PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, I64, I64,
              INT, INT, PTR, PTR)
_CONSTANTS = {"sw_dense_stripe": STRIPE, "sw_dense_max_alpha": MAX_ALPHA}
_BATCH = Entry("sw_dense", "sw_dense", _SIGNATURE, counter="sw_dense_batch",
               cells_counter="sw_dense_cells", constants=_CONSTANTS)
_ONE_QUERY = Entry("sw_dense", "sw_dense", _SIGNATURE,
                   counter="sw_dense_one_query",
                   cells_counter="sw_dense_cells", constants=_CONSTANTS)


@dataclass(frozen=True)
class PackedTargets:
    """Targets in the kernel's layout, on one device."""
    seqs: torch.Tensor   # uint8 [t_total] runs (see the module docstring)
    off: torch.Tensor    # int64 [T] start of each run, a multiple of 16
    lens: torch.Tensor   # int32 [T] true lengths, descending
    order: torch.Tensor  # int64 [T] the caller's index of each run
    alpha: int           # profile width A the letters were mapped for
    n_letters: int       # sum of lens


def pack_targets(t_rows, t_len, alpha: int) -> PackedTargets:
    """Pack t_rows [T, LT] (integer letters, any strides; t_len [T]) for
    a profile of width alpha, on t_rows' device, by pack_runs with the
    pad letter alpha + 1."""
    if not 0 < alpha <= 254:
        raise ValueError(f"sw_dense: profile width {alpha} outside 1..254")
    dev = t_rows.device
    LT = t_rows.shape[1]
    tl = t_len.reshape(-1).to(dev, torch.int64).clamp(0, LT)
    letters = t_rows[torch.arange(LT, device=dev)[None, :] < tl[:, None]]
    seqs, off, lens, order = pack_runs(letters, tl, alpha, alpha + 1)
    return PackedTargets(seqs, off, lens, order, alpha, letters.numel())


def _scan(prof, q_len, letters, scan_len, n_cols, gap_open, gap_extend):
    """int32 [Q, T]: the plain column scan. prof [Q, LQ, C] int32 holds
    the profile and its extra columns; letters [L, T] (any integer type)
    are read as columns, a letter outside [0, n_cols) as column n_cols;
    target t takes columns i < scan_len[t]. Targets are taken in runs of
    at most PLAIN_MAX_ELEMS / (Q * LQ), each scanned up to its own longest
    target (later columns are no-ops)."""
    dev = prof.device
    Q, LQ, _ = prof.shape
    L, T = letters.shape
    out = torch.zeros((Q, T), dtype=torch.int32, device=dev)
    if Q == 0 or T == 0 or LQ == 0 or L == 0:
        return out
    jpos = torch.arange(LQ, dtype=torch.int32, device=dev)
    q_mask = (jpos[None, :] < q_len[:, None])[:, :, None]      # [Q, LQ, 1]
    c1 = (gap_extend * (jpos + 1) - gap_open)[None, :, None]
    c2 = (gap_extend * jpos)[None, :, None]
    chunk = max(1, PLAIN_MAX_ELEMS // (Q * LQ))
    for t0 in range(0, T, chunk):
        tl = scan_len[t0:t0 + chunk]
        nt = tl.numel()
        width = min(int(tl.max()), L)
        if width <= 0:
            continue
        H = torch.zeros((Q, LQ, nt), dtype=torch.int32, device=dev)
        E = torch.zeros_like(H)
        best = torch.zeros((Q, nt), dtype=torch.int32, device=dev)
        zero = torch.zeros((Q, 1, nt), dtype=torch.int32, device=dev)
        neg = torch.full((Q, 1, nt), NEG, dtype=torch.int32, device=dev)
        for i in range(width):
            col = letters[i, t0:t0 + nt].long()
            col = torch.where((col >= 0) & (col < n_cols), col, n_cols)
            sub = prof.index_select(2, col)                    # [Q, LQ, nt]
            h_diag = torch.cat([zero, H[:, :-1, :]], dim=1)
            h_pre = torch.clamp_min(torch.maximum(h_diag + sub, E), 0)
            h_pre = torch.where(q_mask, h_pre, 0)
            E2 = torch.clamp_min(torch.maximum(h_pre - gap_open,
                                               E - gap_extend), 0)
            cm = torch.cummax(h_pre + c1, dim=1).values
            F = torch.cat([neg, cm[:, :-1, :]], dim=1) - c2
            h = torch.where(q_mask, torch.maximum(h_pre, F), 0)
            valid = (i < tl)[None, :]                          # [1, nt]
            best = torch.where(valid, torch.maximum(best, h.amax(dim=1)),
                               best)
            H = torch.where(valid[:, None, :], h, H)
            E = torch.where(valid[:, None, :], E2, E)
        out[:, t0:t0 + nt] = best
    return out


def sw_scores_batch_plain(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                          gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of B4: int32 [Q, T] on the inputs' device.

    A scan over target columns, the JAX body's masks and NEG; column A
    of the profile scores 0, where a letter outside [0, A) reads."""
    dev = q_prof.device
    Q, LQ, A = q_prof.shape
    LT = t_seqs.shape[0]
    prof_z = torch.cat([q_prof.to(torch.int32),
                        torch.zeros((Q, LQ, 1), dtype=torch.int32,
                                    device=dev)], dim=2)
    return _scan(prof_z, q_len.reshape(-1).to(dev, torch.int32), t_seqs,
                 t_len.reshape(-1).to(dev, torch.int64).clamp(0, LT), A,
                 gap_open, gap_extend)


def sw_scores_packed_plain(q_prof, q_len, targets: PackedTargets,
                           gap_open: int = 16,
                           gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of B4 on packed targets, as the kernel sees
    them: the target runs in packed order, each scanned over its whole
    16-letter chunks (pad letters read the NEG column A + 1), and the
    order undone at the end. int32 [Q, T] in the caller's order, equal to
    sw_scores_batch_plain."""
    dev = q_prof.device
    Q, LQ, A = q_prof.shape
    T = targets.order.numel()
    q_len = q_len.reshape(-1).to(dev, torch.int32)
    out = torch.zeros((Q, T), dtype=torch.int32, device=dev)
    padded = (targets.lens.long() + T_ALIGN - 1) // T_ALIGN * T_ALIGN
    if Q == 0 or T == 0 or int(padded.max()) == 0:
        return out
    i = torch.arange(int(padded.max()), device=dev)
    idx = (targets.off[None, :] + i[:, None]).clamp(
        max=targets.seqs.numel() - 1)
    prof = torch.cat([q_prof.to(torch.int32),
                      torch.zeros((Q, LQ, 1), dtype=torch.int32, device=dev),
                      torch.full((Q, LQ, 1), NEG, dtype=torch.int32,
                                 device=dev)], dim=2)
    out[:, targets.order] = _scan(prof, q_len, targets.seqs[idx], padded,
                                  A + 2, gap_open, gap_extend)
    return out


def sw_scores_one_query_plain(q_prof, q_len, t_seqs, t_len,
                              gap_open: int = 16,
                              gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of B3: q_prof [LQ, A], q_len of one element
    -> int32 [T]."""
    return sw_scores_batch_plain(q_prof[None], q_len.reshape(1), t_seqs,
                                 t_len, gap_open, gap_extend)[0]


def _launch(q_prof, q_len, targets: PackedTargets, gap_open, gap_extend,
            one_query):
    """Checks, scratch slots and launches of csrc/sw_dense.cu; int32
    [Q, T] in the caller's order, on the inputs' card."""
    dev = q_prof.device
    Q, LQ, A = q_prof.shape
    T = targets.order.numel()
    check("sw_dense", "q_prof", q_prof, torch.int32, dev)
    check("sw_dense", "q_len", q_len, torch.int32, dev, Q)
    for name, x, dtype in (("seqs", targets.seqs, torch.uint8),
                           ("off", targets.off, torch.int64),
                           ("lens", targets.lens, torch.int32),
                           ("order", targets.order, torch.int64)):
        check("sw_dense", f"packed {name}", x, dtype, dev)
    if targets.alpha != A:
        raise ValueError(f"sw_dense: targets packed for {targets.alpha} "
                         f"profile columns, the profile has {A}")
    if targets.seqs.data_ptr() % T_ALIGN:
        raise ValueError("sw_dense: packed targets must be 16-byte aligned")
    if A > MAX_ALPHA:
        raise ValueError(f"sw_dense: at most {MAX_ALPHA} profile columns, "
                         f"got {A}")
    out = torch.empty((Q, T), dtype=torch.int32, device=dev)
    if Q == 0 or T == 0:
        return out
    q_flat = q_len.reshape(-1)
    lens = q_flat.cpu().clamp(0, LQ)
    t_total = targets.seqs.numel()
    slot, n_slots, bounds = scratch_slots(lens, STRIPE, t_total,
                                          SCRATCH_BYTES)
    scratch = torch.empty(max(n_slots * t_total * 2, 2), dtype=torch.int32,
                          device=dev)
    slot_d = slot.to(dev)
    entry = _ONE_QUERY if one_query else _BATCH
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        entry(q_prof[q0:], q_flat[q0:], slot_d[q0:], targets.seqs,
              targets.off, targets.lens, targets.order, q1 - q0, LQ, A, T,
              t_total, T, gap_open, gap_extend, scratch, out[q0:],
              cells=int(lens[q0:q1].sum()) * targets.n_letters)
    return out


def sw_scores_packed(q_prof, q_len, targets: PackedTargets,
                     gap_open: int = 16, gap_extend: int = 2) -> torch.Tensor:
    """B4 on targets packed by pack_targets (the mesh's entry): int32
    [Q, T] in the caller's order. On CUDA tensors this launches
    csrc/sw_dense.cu and raises if the kernel cannot be built or
    launched; on CPU tensors it runs sw_scores_packed_plain."""
    if not on_card("sw_scores_packed", q_prof):
        return sw_scores_packed_plain(q_prof, q_len, targets, gap_open,
                                      gap_extend)
    return _launch(q_prof, q_len, targets, gap_open, gap_extend, False)


def _dispatch(plain, q_prof, q_len, t_seqs, t_len, gap_open, gap_extend,
              one_query):
    if not on_card("sw_dense", q_prof):
        return plain(q_prof, q_len, t_seqs, t_len, gap_open, gap_extend)
    dev = q_prof.device
    if t_seqs.dim() != 2:
        raise ValueError("sw_dense: t_seqs must be [LT, T]")
    check("sw_dense", "t_seqs", t_seqs, torch.int32, dev)
    check("sw_dense", "t_len", t_len, torch.int32, dev, t_seqs.shape[1])
    prof = q_prof[None] if one_query else q_prof
    out = _launch(prof, q_len, pack_targets(t_seqs.t(), t_len,
                                            prof.shape[2]),
                  gap_open, gap_extend, one_query)
    return out[0] if one_query else out


def sw_scores_batch(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                    gap_extend: int = 2) -> torch.Tensor:
    """B4: int32 [Q, T] best scores of q_prof [Q, LQ, A] (q_len [Q])
    against t_seqs [LT, T] (t_len [T]); q_len and t_len may carry the JAX
    package's [Q, 1, 1] and [1, T] shapes.

    On CUDA tensors this packs the targets and launches csrc/sw_dense.cu,
    and raises if the kernel cannot be built or launched; on CPU tensors
    it runs sw_scores_batch_plain."""
    return _dispatch(sw_scores_batch_plain, q_prof, q_len, t_seqs, t_len,
                     gap_open, gap_extend, False)


def sw_scores_one_query(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                        gap_extend: int = 2) -> torch.Tensor:
    """B3: int32 [T] best scores of one query profile [LQ, A] (q_len of
    one element) against t_seqs [LT, T]; the kernel at Q = 1, or plain,
    as sw_scores_batch."""
    return _dispatch(sw_scores_one_query_plain, q_prof, q_len, t_seqs, t_len,
                     gap_open, gap_extend, True)


def pack_for_pallas(q_num, matrix_scores, targets, lq_pad=32, a_pad=32,
                    lt_pad=None, t_tile=256, bias=None, x_fill=20):
    """Host packing for the Pallas scorer."""
    lq = len(q_num)
    prof = np.full((lq_pad, a_pad), NEG, dtype=np.int32)
    p = matrix_scores[np.asarray(q_num, dtype=np.int64)].astype(np.int32)
    if bias is not None:
        p = p + np.asarray(bias, dtype=np.int32)[:, None]
    prof[:lq, :p.shape[1]] = p
    T = len(targets)
    T_pad = ((T + t_tile - 1) // t_tile) * t_tile
    lt = lt_pad or max((len(t) for t in targets), default=1)
    t_seqs = np.full((lt, T_pad), x_fill, dtype=np.int32)
    t_len = np.zeros((1, T_pad), dtype=np.int32)
    for i, t in enumerate(targets):
        tt = np.asarray(t, dtype=np.int64)[:lt]
        t_seqs[:len(tt), i] = tt
        t_len[0, i] = len(tt)
    return prof, np.array([[lq]], dtype=np.int32), t_seqs, t_len, T
