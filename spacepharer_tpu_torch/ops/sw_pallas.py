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
"""
import ctypes

import numpy as np
import torch

NEG = -(10 ** 6)
STRIPE = 16                 # query rows per register stripe (csrc/sw_dense.cu)
SCRATCH_BYTES = 1 << 31     # stripe-boundary scratch per launch
PLAIN_MAX_ELEMS = 1 << 26   # DP-state elements per target run (plain)

# kernel launches made by the two wrappers, and the true DP cells (query
# rows < q_len x target columns < t_len) they scored; the plain CPU path
# counts in none of them
one_query_launches = 0
batch_launches = 0
cells = 0


def sw_scores_batch_plain(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                          gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of B4: int32 [Q, T] on the inputs' device.

    A scan over target columns, the JAX body's masks and NEG; targets are
    taken in runs of at most PLAIN_MAX_ELEMS / (Q * LQ), each scanned up to
    its own longest target (later columns are no-ops)."""
    dev = q_prof.device
    Q, LQ, A = q_prof.shape
    LT, T = t_seqs.shape
    q_len = q_len.reshape(-1).to(dev, torch.int32)
    t_len = t_len.reshape(-1).to(dev, torch.int32)
    out = torch.zeros((Q, T), dtype=torch.int32, device=dev)
    if Q == 0 or T == 0 or LQ == 0 or LT == 0:
        return out
    jpos = torch.arange(LQ, dtype=torch.int32, device=dev)
    q_mask = (jpos[None, :] < q_len[:, None])[:, :, None]      # [Q, LQ, 1]
    c1 = (gap_extend * (jpos + 1) - gap_open)[None, :, None]
    c2 = (gap_extend * jpos)[None, :, None]
    # column A scores 0: where a letter outside [0, A) reads
    prof_z = torch.cat([q_prof.to(torch.int32),
                        torch.zeros((Q, LQ, 1), dtype=torch.int32,
                                    device=dev)], dim=2)
    chunk = max(1, PLAIN_MAX_ELEMS // (Q * LQ))
    for t0 in range(0, T, chunk):
        tl = t_len[t0:t0 + chunk]
        nt = tl.numel()
        width = min(int(tl.max()), LT)
        if width <= 0:
            continue
        H = torch.zeros((Q, LQ, nt), dtype=torch.int32, device=dev)
        E = torch.zeros_like(H)
        best = torch.zeros((Q, nt), dtype=torch.int32, device=dev)
        zero = torch.zeros((Q, 1, nt), dtype=torch.int32, device=dev)
        neg = torch.full((Q, 1, nt), NEG, dtype=torch.int32, device=dev)
        for i in range(width):
            letters = t_seqs[i, t0:t0 + nt].long()
            letters = torch.where((letters >= 0) & (letters < A), letters, A)
            sub = prof_z.index_select(2, letters)              # [Q, LQ, nt]
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


def sw_scores_one_query_plain(q_prof, q_len, t_seqs, t_len,
                              gap_open: int = 16,
                              gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of B3: q_prof [LQ, A], q_len of one element
    -> int32 [T]."""
    return sw_scores_batch_plain(q_prof[None], q_len.reshape(1), t_seqs,
                                 t_len, gap_open, gap_extend)[0]


def _check(x, name, dev, numel=None):
    if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"sw_dense: {name} must be a contiguous int32 "
                         f"tensor on {dev}, got {x.dtype} on {x.device}")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"sw_dense: {name} must have {numel} elements, "
                         f"got {x.numel()}")


def _launch(q_prof, q_len, t_seqs, t_len, gap_open, gap_extend, one_query):
    """Checks, scratch slots and launches of csrc/sw_dense.cu; int32
    [Q, T] on the inputs' card."""
    global one_query_launches, batch_launches, cells
    dev = q_prof.device
    Q, LQ, A = q_prof.shape
    if t_seqs.dim() != 2:
        raise ValueError("sw_dense: t_seqs must be [LT, T]")
    LT, T = t_seqs.shape
    _check(q_prof, "q_prof", dev)
    _check(q_len, "q_len", dev, Q)
    _check(t_seqs, "t_seqs", dev)
    _check(t_len, "t_len", dev, T)
    from ._cuda import library
    lib = library("sw_dense")
    if lib.sw_dense_stripe() != STRIPE:
        raise RuntimeError("sw_dense: STRIPE disagrees with the kernel")
    if A > lib.sw_dense_max_alpha():
        raise ValueError(f"sw_dense: at most {lib.sw_dense_max_alpha()} "
                         f"profile columns, got {A}")
    out = torch.empty((Q, T), dtype=torch.int32, device=dev)
    if Q == 0 or T == 0:
        return out
    # queries longer than one stripe hand stripe boundaries through a
    # scratch line [LT, T] of int2 each; bound the scratch per launch
    lens = q_len.reshape(-1).cpu().clamp(0, LQ)
    long_q = lens > STRIPE
    per_launch = max(1, SCRATCH_BYTES // (8 * max(LT, 1) * T))
    n_slots = min(int(long_q.sum()), per_launch)
    scratch = torch.empty(max(n_slots * LT * T * 2, 2), dtype=torch.int32,
                          device=dev)
    bounds = [0, Q]
    if not one_query:       # B3's one query takes slot 0
        rank = torch.cumsum(long_q.long(), 0) - 1
        slot_d = torch.where(long_q, rank % per_launch, -1).int().to(dev)
        group = torch.clamp_min(rank, 0) // per_launch
        starts = set((torch.nonzero(group[1:] != group[:-1]).flatten()
                      + 1).tolist())
        starts.update(range(0, Q, lib.sw_dense_max_queries()))
        bounds = sorted(starts) + [Q]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    t_cells = int(t_len.clamp(0, LT).sum())
    common = (ctypes.c_int(LT), ctypes.c_int(gap_open),
              ctypes.c_int(gap_extend), ctypes.c_void_p(scratch.data_ptr()))
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        head = (ctypes.c_void_p(q_prof[q0].data_ptr()),
                ctypes.c_void_p(q_len.reshape(-1)[q0:].data_ptr()))
        tail = (ctypes.c_void_p(t_seqs.data_ptr()),
                ctypes.c_void_p(t_len.data_ptr()))
        if one_query:
            err = lib.sw_one_query(*head, *tail, ctypes.c_int(LQ),
                                   ctypes.c_int(A), ctypes.c_int(T), *common,
                                   ctypes.c_void_p(out.data_ptr()), stream)
        else:
            err = lib.sw_batch(*head, ctypes.c_void_p(slot_d[q0:].data_ptr()),
                               *tail, ctypes.c_int(q1 - q0), ctypes.c_int(LQ),
                               ctypes.c_int(A), ctypes.c_int(T), *common,
                               ctypes.c_void_p(out[q0].data_ptr()), stream)
        if err != 0:
            raise RuntimeError(f"sw_dense kernel launch failed: CUDA error "
                               f"{err}")
        if one_query:
            one_query_launches += 1
        else:
            batch_launches += 1
        cells += int(lens[q0:q1].sum()) * t_cells
    return out


def _dispatch(plain, q_prof, q_len, t_seqs, t_len, gap_open, gap_extend,
              one_query):
    dev = q_prof.device
    if dev.type == "cpu":
        return plain(q_prof, q_len, t_seqs, t_len, gap_open, gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_dense: unsupported device {dev}")
    if one_query:
        return _launch(q_prof[None], q_len, t_seqs, t_len, gap_open,
                       gap_extend, True)[0]
    return _launch(q_prof, q_len, t_seqs, t_len, gap_open, gap_extend, False)


def sw_scores_batch(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                    gap_extend: int = 2) -> torch.Tensor:
    """B4: int32 [Q, T] best scores of q_prof [Q, LQ, A] (q_len [Q])
    against t_seqs [LT, T] (t_len [T]); q_len and t_len may carry the JAX
    package's [Q, 1, 1] and [1, T] shapes.

    On CUDA tensors this launches csrc/sw_dense.cu and raises if the
    kernel cannot be built or launched; on CPU tensors it runs
    sw_scores_batch_plain."""
    return _dispatch(sw_scores_batch_plain, q_prof, q_len, t_seqs, t_len,
                     gap_open, gap_extend, False)


def sw_scores_one_query(q_prof, q_len, t_seqs, t_len, gap_open: int = 16,
                        gap_extend: int = 2) -> torch.Tensor:
    """B3: int32 [T] best scores of one query profile [LQ, A] (q_len of
    one element) against t_seqs [LT, T]; CUDA or plain as sw_scores_batch."""
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
