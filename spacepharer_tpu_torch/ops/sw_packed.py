"""All-pairs Smith-Waterman scorer on the GPU (the production device scorer).

The port of spacepharer_tpu/ops/sw_packed.py. It scores every query
against every target with the exact affine-gap SW best local score
(Farrar E-from-pre-F semantics, the reference's sw_sse2_byte,
lib/mmseqs/src/alignment/StripedSmithWaterman.cpp), cell for cell equal
to ops.align._forward_pass and to the TPU kernel it replaces.

Layout (host packing, shared by the CUDA kernel and its plain version):

  prof   int32 [R, 32]  query profile rows, all queries concatenated:
                        row r of query q is matrix[q_j] + bias[j] for the
                        matrix's letters, NEG for letters it lacks (pad 31)
  q_off  int64 [n_q+1]  first profile row of each query
  t_seqs uint8 [t_total] target letters, each target starting at a
                        multiple of 16 and padded with letter 31 to one
  t_off  int64 [n_t]    start of each target in t_seqs
  t_len  int32 [n_t]    true target lengths

Targets are packed longest first (a warp of the kernel then holds
targets of near-equal length); ``tpack["order"]`` maps packed slots back
to the caller's order. Empty queries and empty targets score 0.

The TPU kernel's lane packing, BIG*qid segmented cummax, one-hot MXU
gather and harvest matmul have no counterpart: they map its DP onto
(8, 128) vector tiles. Without them there is no score ceiling and no
query-length limit, so every query rides the kernel (the TPU path sent
queries with bound >= 4096 or length > 2048 to the bucketed scan).
"""
import ctypes

import numpy as np
import torch

A_PAD = 32            # profile columns; letters 21..31 are pad
PAD_LETTER = A_PAD - 1
NEG = -(1 << 24)      # profile value of pad letters and pad rows
T_ALIGN = 16          # target start alignment (one 128-bit load)
STRIPE = 16           # query rows per register stripe (csrc/sw_allpairs.cu)
SCRATCH_BYTES = 1 << 30   # stripe-boundary scratch per launch
PLAIN_MAX_ELEMS = 1 << 24  # DP-state elements per target run (plain)

# kernel launches made by sw_allpairs, and the true DP cells (query
# residues x target residues) they scored; the plain CPU path counts in
# neither
launches = 0
cells = 0
# None, or a list to which each kernel call appends a (start, stop) pair of
# CUDA events recorded around its launches alone (the host work of the
# wrapper left out)
launch_events = None


def pack_queries(q_list, matrix_scores, bias_list=None):
    """Profile rows of all queries, concatenated (see module docstring).
    Returns dict(prof int32 [R, 32], q_off int64 [n_q+1])."""
    lens = np.array([len(q) for q in q_list], dtype=np.int64)
    q_off = np.zeros(len(q_list) + 1, dtype=np.int64)
    np.cumsum(lens, out=q_off[1:])
    prof = np.full((int(q_off[-1]), A_PAD), NEG, dtype=np.int32)
    if len(prof):
        qcat = np.concatenate([np.asarray(q, dtype=np.int64)
                               for q in q_list])
        rows = matrix_scores[qcat].astype(np.int32)
        if bias_list is not None:
            bcat = np.concatenate(
                [np.asarray(bias_list[i], dtype=np.int32)[:lens[i]]
                 for i in range(len(q_list))])
            rows = rows + bcat[:, None]
        prof[:, :rows.shape[1]] = rows
    return {"prof": prof, "q_off": q_off}


def pack_runs(letters, lens, alpha: int, pad: int):
    """The target layout of kernels B1 and B4, on letters' device.

    letters: every target's letters concatenated in the caller's order
    (any integer type), lens int [n_t]. The targets are sorted by length,
    longest first (stable), and each becomes one uint8 run starting at a
    multiple of T_ALIGN and padded to one with `pad`; a letter outside
    [0, alpha) is stored as alpha. Returns (t_seqs uint8 [max(total,
    T_ALIGN)], t_off int64 [n_t], t_len int32 [n_t] descending, order
    int64 [n_t]: the caller's index of each run)."""
    dev = letters.device
    lens = lens.reshape(-1).to(dev, torch.int64)
    n_t = lens.numel()
    s_lens, order = torch.sort(lens, descending=True, stable=True)
    padded = (s_lens + T_ALIGN - 1) // T_ALIGN * T_ALIGN
    t_off = torch.cumsum(padded, 0) - padded
    total = int(padded.sum()) if n_t else 0
    t_seqs = torch.full((max(total, T_ALIGN),), pad, dtype=torch.uint8,
                        device=dev)
    n_res = letters.numel()
    if n_res:
        run = torch.empty_like(order)
        run[order] = torch.arange(n_t, device=dev)
        tid = torch.repeat_interleave(torch.arange(n_t, device=dev), lens,
                                      output_size=n_res)
        start = torch.cumsum(lens, 0) - lens
        pos = t_off[run[tid]] + torch.arange(n_res, device=dev) - start[tid]
        x = letters.reshape(-1).long()
        t_seqs[pos] = torch.where((x >= 0) & (x < alpha), x,
                                  alpha).to(torch.uint8)
    return t_seqs, t_off, s_lens.to(torch.int32), order


def pack_targets(t_list):
    """Targets longest first, 16-aligned, pad letter 31 (see module
    docstring and pack_runs). Returns dict(t_seqs uint8, t_off int64
    [n_t], t_len int32 [n_t], order int64 [n_t]: caller index of each
    packed slot), numpy arrays."""
    lens = np.array([len(t) for t in t_list], dtype=np.int64)
    tcat = (np.concatenate([np.asarray(t, dtype=np.int64) for t in t_list])
            if lens.sum() else np.zeros(0, np.int64))
    if tcat.size and (tcat.min() < 0 or tcat.max() >= PAD_LETTER):
        raise ValueError("target letters must lie in [0, 31)")
    packed = pack_runs(torch.from_numpy(tcat), torch.from_numpy(lens),
                       PAD_LETTER, PAD_LETTER)
    return dict(zip(("t_seqs", "t_off", "t_len", "order"),
                    (x.numpy() for x in packed)))


def sw_allpairs_plain(prof, q_off, t_seqs, t_off, t_len,
                      gap_open: int = 16, gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel: int32 [n_q, n_t] best
    scores, same inputs, on their device.

    All pairs advance together one target column at a time; F comes from
    the cumulative-max identity of ops/sw_tpu.py. Pad rows and pad
    letters need no masks (see csrc/sw_allpairs.cu). Targets are taken
    in runs of at most PLAIN_MAX_ELEMS / (n_q * longest query) so the DP
    state stays bounded."""
    dev = prof.device
    n_q, n_t = q_off.numel() - 1, t_len.numel()
    out = torch.zeros((n_q, n_t), dtype=torch.int32, device=dev)
    q_lens = (q_off[1:] - q_off[:-1]).cpu()
    lq = int(q_lens.max()) if n_q else 0
    if lq == 0 or n_t == 0 or int(t_len.max()) == 0:
        return out
    # prof_t[a, q, j]: profile of query q row j at letter a (NEG pad rows)
    j = torch.arange(lq, device=dev)
    q_lens_d = q_lens.to(dev)
    rows = (q_off[:-1, None] + j[None, :]).clamp(max=prof.shape[0] - 1)
    prof_q = torch.where((j[None, :] < q_lens_d[:, None])[:, :, None],
                         prof[rows], NEG)
    prof_t = prof_q.permute(2, 0, 1).contiguous()          # [32, n_q, lq]
    c1 = (gap_extend * (j + 1) - gap_open).to(torch.int32)
    c2 = (gap_extend * j).to(torch.int32)
    chunk = max(1, PLAIN_MAX_ELEMS // (n_q * lq))
    for t0 in range(0, n_t, chunk):
        tl = t_len[t0:t0 + chunk].long()
        nt = tl.numel()
        width = int(tl.max())
        if width == 0:
            continue
        i = torch.arange(width, device=dev)
        idx = (t_off[t0:t0 + chunk, None] + i[None, :]).clamp(
            max=t_seqs.numel() - 1)
        letters = torch.where(i[None, :] < tl[:, None], t_seqs[idx].long(),
                              PAD_LETTER)                  # [nt, width]
        H = torch.zeros((nt, n_q, lq), dtype=torch.int32, device=dev)
        E = torch.zeros_like(H)
        best = torch.zeros((nt, n_q), dtype=torch.int32, device=dev)
        zero = torch.zeros((nt, n_q, 1), dtype=torch.int32, device=dev)
        neg = torch.full((nt, n_q, 1), NEG, dtype=torch.int32, device=dev)
        for col in range(width):
            sub = prof_t[letters[:, col]]                  # [nt, n_q, lq]
            h_diag = torch.cat([zero, H[:, :, :-1]], dim=2)
            h_pre = torch.maximum(h_diag + sub, E)
            E = torch.clamp_min(torch.maximum(h_pre - gap_open,
                                              E - gap_extend), 0)
            cm = torch.cummax(h_pre + c1, dim=2).values
            F = torch.cat([neg, cm[:, :, :-1]], dim=2) - c2
            H = torch.maximum(h_pre, F)
            best = torch.maximum(best, H.amax(dim=2))
        out[:, t0:t0 + nt] = best.T
    return out


def _check(name, x, dtype, dev):
    if x.device != dev or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"sw_allpairs: {name} must be a contiguous {dtype} "
                         f"tensor on {dev}, got {x.dtype} on {x.device}")


def sw_allpairs(prof, q_off, t_seqs, t_off, t_len, gap_open: int = 16,
                gap_extend: int = 2) -> torch.Tensor:
    """int32 [n_q, n_t] best SW scores (layout: module docstring).

    On CUDA tensors this launches csrc/sw_allpairs.cu and raises if the
    kernel cannot be built or launched; on CPU tensors it runs
    sw_allpairs_plain."""
    global launches, cells
    dev = prof.device
    if dev.type == "cpu":
        return sw_allpairs_plain(prof, q_off, t_seqs, t_off, t_len,
                                 gap_open, gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"sw_allpairs: unsupported device {dev}")
    for name, x, dtype in (("prof", prof, torch.int32),
                           ("q_off", q_off, torch.int64),
                           ("t_seqs", t_seqs, torch.uint8),
                           ("t_off", t_off, torch.int64),
                           ("t_len", t_len, torch.int32)):
        _check(name, x, dtype, dev)
    if prof.dim() != 2 or prof.shape[1] != A_PAD:
        raise ValueError(f"sw_allpairs: prof must be [R, {A_PAD}]")
    if t_seqs.data_ptr() % T_ALIGN:
        raise ValueError("sw_allpairs: t_seqs must be 16-byte aligned")
    from ._cuda import library
    lib = library("sw_allpairs")
    if lib.sw_allpairs_stripe() != STRIPE:
        raise RuntimeError("sw_allpairs: STRIPE disagrees with the kernel")
    n_q, n_t = q_off.numel() - 1, t_len.numel()
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=dev)
    if n_q == 0 or n_t == 0:
        return out
    # queries longer than one stripe hand stripe boundaries through a
    # scratch line per target residue; bound it per launch
    q_lens = (q_off[1:] - q_off[:-1]).cpu()
    t_total = t_seqs.numel()
    long_q = q_lens > STRIPE
    per_launch = max(1, SCRATCH_BYTES // (8 * t_total))
    slot = torch.full((n_q,), -1, dtype=torch.int32)
    group = torch.zeros(n_q, dtype=torch.int64)
    if bool(long_q.any()):
        rank = torch.cumsum(long_q.long(), 0) - 1
        slot[long_q] = (rank[long_q] % per_launch).int()
        group = torch.clamp_min(rank, 0) // per_launch
    n_slots = min(int(long_q.sum()), per_launch)
    scratch = torch.empty(max(n_slots * t_total * 2, 2), dtype=torch.int32,
                          device=dev)
    slot_d = slot.to(dev)
    cur = torch.cuda.current_stream(dev)
    stream = cur.cuda_stream
    bounds = [0] + (torch.nonzero(group[1:] != group[:-1]).flatten() + 1
                    ).tolist() + [n_q]
    t_cells = int(t_len.sum())
    events = None
    if launch_events is not None:
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record(cur)
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        err = lib.sw_allpairs_launch(
            ctypes.c_void_p(prof.data_ptr()),
            ctypes.c_void_p(q_off[q0:].data_ptr()),
            ctypes.c_void_p(slot_d[q0:].data_ptr()),
            ctypes.c_void_p(t_seqs.data_ptr()),
            ctypes.c_void_p(t_off.data_ptr()),
            ctypes.c_void_p(t_len.data_ptr()),
            ctypes.c_int(q1 - q0), ctypes.c_int(n_t),
            ctypes.c_longlong(t_total), ctypes.c_int(gap_open),
            ctypes.c_int(gap_extend), ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(out[q0:].data_ptr()), ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"sw_allpairs kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        cells += int(q_lens[q0:q1].sum()) * t_cells
    if events is not None:
        events[1].record(cur)
        launch_events.append(events)
    return out


def allpairs_scores(qpack, tpack, gap_open: int = 16, gap_extend: int = 2,
                    device="cuda") -> np.ndarray:
    """int32 [n_q, n_t] scores in the caller's target order, computed by
    sw_allpairs on `device` from host packs."""
    dev = torch.device(device)
    raw = sw_allpairs(
        torch.from_numpy(qpack["prof"]).to(dev),
        torch.from_numpy(qpack["q_off"]).to(dev),
        torch.from_numpy(tpack["t_seqs"]).to(dev),
        torch.from_numpy(tpack["t_off"]).to(dev),
        torch.from_numpy(tpack["t_len"]).to(dev),
        gap_open=gap_open, gap_extend=gap_extend)
    # back to the caller's column order on the device: a host-side
    # column scatter of a 5e7-cell block costs about a second
    out = torch.empty_like(raw)
    out[:, torch.from_numpy(tpack["order"]).to(dev)] = raw
    return out.cpu().numpy()


def device_allpairs_scores(q_list, t_list, matrix_scores, bias_list=None,
                           gap_open: int = 16, gap_extend: int = 2,
                           device="cuda") -> np.ndarray:
    """[n_queries, n_targets] exact SW scores (int32, numpy) via
    sw_allpairs on `device`: the bulk entry of the scoring engine."""
    qpack = pack_queries(q_list, matrix_scores, bias_list)
    tpack = pack_targets(t_list)
    return allpairs_scores(qpack, tpack, gap_open, gap_extend, device)
