"""Smith-Waterman scorer B1 on the GPU (the production device scorer).

The port of spacepharer_tpu/ops/sw_packed.py. It gives the exact
affine-gap SW best local score (Farrar E-from-pre-F semantics, the
reference's sw_sse2_byte, lib/mmseqs/src/alignment/StripedSmithWaterman.cpp),
cell for cell equal to ops.align._forward_pass and to the TPU kernel it
replaces, through two entries of csrc/sw_allpairs.cu:

  sw_allpairs   every query against every target (int32 [n_q, n_t]);
  sw_pairs      a list of (query, target) pairs, one score each: the GPU
                scoring engine's entry (device_pair_scores), which scores
                the host prefilter's candidate pairs and nothing around
                them.

The pair-list entry's query profiles, with each residue's composition
bias, are built on the card by csrc/pair_profile.cu (pair_profile).

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

The pair-list entry takes its own layout (pack_pair_queries; the
targets as the search holds them):

  prof      int8 [S, 32, 16]  each query's profile in 16-row stripes,
                              bias folded in: prof[s, a, r] scores row r
                              of stripe s at letter a; -128 for pad rows
                              and letters the matrix lacks
  q_stripe  int64 [n_q]       first stripe of each query
  q_len     int32 [n_q]       query lengths
  t_seqs    uint8 [t_total + T_PAD]  every target's letters,
                              concatenated (the kernel reads 4 letters at
                              a time, up to T_PAD bytes past the last)
  t_off     int64 [n_t+1]     target t is t_seqs[t_off[t]:t_off[t+1]]
  pair_q, pair_t  int32 [n]   the pairs, in any order

The TPU kernel's lane packing, BIG*qid segmented cummax, one-hot MXU
gather and harvest matmul have no counterpart: they map its DP onto
(8, 128) vector tiles. Without them there is no score ceiling and no
query-length limit, so every query rides the kernel (the TPU path sent
queries with bound >= 4096 or length > 2048 to the bucketed scan).
"""
import numpy as np
import torch

from ..logging import count, span
from ._cuda import I64, INT, PTR, Entry, check, on_card, upload

A_PAD = 32            # profile columns; letters 21..31 are pad
PAD_LETTER = A_PAD - 1
NEG = -(1 << 24)      # profile value of pad letters and pad rows
T_ALIGN = 16          # target start alignment (one 128-bit load)
STRIPE = 16           # query rows per register stripe (csrc/sw_allpairs.cu)
SCRATCH_BYTES = 1 << 30   # stripe-boundary scratch per launch
PLAIN_MAX_ELEMS = 1 << 24  # DP-state elements per target run (plain)
PROF8_NEG = -128      # pair-list profile value of pad rows and absent letters
T_PAD = 8             # readable bytes the pair kernel needs past t_seqs' end
PAIR_CHUNK = 1 << 24  # pairs per sw_pairs call in device_pair_scores
# serial work (query stripes x target length) from which a pair leaves the
# pair kernel's bulk (a thread a pair) for its tail (a half-warp a pair).
# Swept by tools/time_pair_kernel.py --sweep (since removed; in git
# history from commit a270f26) on chip_smoke.py phase 3's first search
# (46,605 pairs; NVIDIA H100 80GB HBM3, 700 W): the kernels took 0.1129,
# 0.0859, 0.0857, 0.0854 ms at 256, 384, 512, 640 (7,699, 3,380, 1,774 and
# 604 tail pairs): flat from 384 to 640, 512 in its middle
PAIR_TAIL_WORK = 512
# the pair kernel's layout, as csrc/sw_allpairs.cu's sw_pairs_layout()
# reports it (checked when the library is first loaded)
TAIL_KEY = 1 << 14    # int16 sort-key bit of a tail pair
KEY_LEN_BITS = 11     # a bulk key: stripes, > SHORT_ROWS rows, length
SHORT_ROWS = 12       # rows of the bulk's variant for short queries
LINE_COLS = 16        # a scratch line's length rounds up to this
PROFILE_FLAG_LETTER = 2  # pair_profile.cu's flag bit: a letter >= alpha

# The wrappers count in the registry (logging.count): sw_allpairs's
# kernel launches in sw_allpairs_launches and the true DP cells (query
# residues x target residues) they scored in sw_allpairs_cells; the same
# two for sw_pairs, the pair-list entry, in sw_pairs_launches and
# pair_cells, and the launches of its key pass (pair_keys) in
# sw_pairs_keys_launches; pair_profile's launches (csrc/pair_profile.cu)
# in pair_profile_launches. The plain CPU path counts in none of them.
_LAYOUT = {"sw_allpairs_stripe": STRIPE,
           "sw_pairs_layout": (STRIPE, TAIL_KEY, KEY_LEN_BITS, SHORT_ROWS,
                               LINE_COLS)}
_ALLPAIRS = Entry("sw_allpairs", "sw_allpairs",
                  (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, I64, INT, INT,
                   PTR, PTR), counter="sw_allpairs",
                  cells_counter="sw_allpairs_cells", constants=_LAYOUT)
_PAIR_KEYS = Entry("sw_allpairs", "sw_pairs_keys",
                   (PTR, PTR, PTR, PTR, INT, I64, PTR, PTR, PTR),
                   counter="sw_pairs_keys", constants=_LAYOUT)
_PAIRS = Entry("sw_allpairs", "sw_pairs",
               (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, I64,
                INT, INT, PTR, PTR), counter="sw_pairs", constants=_LAYOUT)
_PROFILE = Entry("pair_profile", "pair_profile",
                 (PTR, PTR, PTR, INT, I64, PTR, PTR, INT, INT, PTR, PTR),
                 counter="pair_profile",
                 constants={"pair_profile_max_alpha": A_PAD})


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


def scratch_slots(q_lens, stripe: int, t_total: int, scratch_bytes: int):
    """(slot int32 [n_q], n_slots, bounds) of kernels B1 (sw_allpairs) and
    B4: a query longer than one stripe hands its stripe boundaries
    through a scratch line of one int2 per packed target letter (t_total),
    and a launch has scratch_bytes of lines. The long queries take slots
    0, 1, ... in order, per_launch = scratch_bytes // (8 t_total) of them
    (at least 1) a launch; slot[q] is query q's slot (-1 for a short
    one), n_slots the lines to allocate, and launch k takes the queries
    bounds[k]:bounds[k + 1]. q_lens: the query lengths, a CPU tensor."""
    long_q = q_lens > stripe
    per_launch = max(1, scratch_bytes // (8 * t_total))
    rank = torch.cumsum(long_q.long(), 0) - 1
    slot = torch.where(long_q, rank % per_launch, -1).int()
    group = torch.clamp_min(rank, 0) // per_launch
    bounds = [0] + (torch.nonzero(group[1:] != group[:-1]).flatten()
                    + 1).tolist() + [q_lens.numel()]
    return slot, min(int(long_q.sum()), per_launch), bounds


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


def sw_allpairs(prof, q_off, t_seqs, t_off, t_len, gap_open: int = 16,
                gap_extend: int = 2) -> torch.Tensor:
    """int32 [n_q, n_t] best SW scores (layout: module docstring).

    On CUDA tensors this launches csrc/sw_allpairs.cu and raises if the
    kernel cannot be built or launched; on CPU tensors it runs
    sw_allpairs_plain."""
    if not on_card("sw_allpairs", prof):
        return sw_allpairs_plain(prof, q_off, t_seqs, t_off, t_len,
                                 gap_open, gap_extend)
    dev = prof.device
    for name, x, dtype in (("prof", prof, torch.int32),
                           ("q_off", q_off, torch.int64),
                           ("t_seqs", t_seqs, torch.uint8),
                           ("t_off", t_off, torch.int64),
                           ("t_len", t_len, torch.int32)):
        check("sw_allpairs", name, x, dtype, dev)
    if prof.dim() != 2 or prof.shape[1] != A_PAD:
        raise ValueError(f"sw_allpairs: prof must be [R, {A_PAD}]")
    if t_seqs.data_ptr() % T_ALIGN:
        raise ValueError("sw_allpairs: t_seqs must be 16-byte aligned")
    n_q, n_t = q_off.numel() - 1, t_len.numel()
    out = torch.empty((n_q, n_t), dtype=torch.int32, device=dev)
    if n_q == 0 or n_t == 0:
        return out
    q_lens = (q_off[1:] - q_off[:-1]).cpu()
    t_total = t_seqs.numel()
    slot, n_slots, bounds = scratch_slots(q_lens, STRIPE, t_total,
                                          SCRATCH_BYTES)
    scratch = torch.empty(max(n_slots * t_total * 2, 2), dtype=torch.int32,
                          device=dev)
    slot_d = slot.to(dev)
    t_cells = int(t_len.sum())
    for q0, q1 in zip(bounds[:-1], bounds[1:]):
        _ALLPAIRS(prof, q_off[q0:], slot_d[q0:], t_seqs, t_off, t_len,
                  q1 - q0, n_t, t_total, gap_open, gap_extend, scratch,
                  out[q0:], cells=int(q_lens[q0:q1].sum()) * t_cells)
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


def pack_pair_queries(q_list, matrix_scores, bias_list=None, device="cpu",
                      expected=None):
    """The pair-list entry's query profiles (module docstring), built on
    `device` from the queries' letters (one upload):
    dict(prof int8 [S, 32, 16], q_stripe int64 [n_q], q_len int32 [n_q]).
    bias_list, when given, holds one bias per query residue, added to
    each profile row here. Without it the profile comes from pair_profile
    (csrc/pair_profile.cu on a card): with `expected`, the matrix's
    float64 expected-score table (ops/bias.py::expected_score_tab), it
    computes each residue's composition bias in the same pass (sw_bias_i8
    bit for bit), else none. Raises ValueError where a score plus its bias
    leaves [-127, 127] (every shipped matrix with its int8 bias lies well
    inside)."""
    if bias_list is not None and expected is not None:
        raise ValueError("pack_pair_queries: either biases or the "
                         "expected-score table, not both")
    dev = torch.device(device)
    lens = np.fromiter((len(q) for q in q_list), dtype=np.int64,
                       count=len(q_list))
    n_str = (lens + STRIPE - 1) // STRIPE
    q_stripe = np.zeros(len(q_list), dtype=np.int64)
    np.cumsum(n_str[:-1], out=q_stripe[1:])
    total = int(lens.sum())
    q_stripe_d = upload(q_stripe, dev)
    lens_d = upload(lens, dev)
    out = {"q_stripe": q_stripe_d, "q_len": lens_d.to(torch.int32)}
    qcat = (np.concatenate(q_list) if total else np.zeros(0, np.int64))
    if total and int(qcat.max()) >= matrix_scores.shape[1]:
        raise ValueError("pack_pair_queries: query letters must lie in the "
                         "matrix's alphabet")
    if bias_list is None:
        q_off = np.zeros(len(q_list) + 1, dtype=np.int64)
        np.cumsum(lens, out=q_off[1:])
        tab = (np.zeros(matrix_scores.shape[1]) if expected is None
               else expected)
        out["prof"] = pair_profile(
            upload(qcat.astype(np.uint8), dev), upload(q_off, dev),
            q_stripe_d, int(n_str.sum()),
            upload(np.ascontiguousarray(matrix_scores, dtype=np.int32), dev),
            upload(np.ascontiguousarray(tab, dtype=np.float64), dev),
            comp_bias=expected is not None)
        return out
    prof = torch.full((int(n_str.sum()) * A_PAD * STRIPE,), PROF8_NEG,
                      dtype=torch.int8, device=dev)
    if total:
        qcat = upload(qcat, dev).long()
        rows = upload(np.ascontiguousarray(matrix_scores, dtype=np.int32),
                      dev)[qcat]
        bcat = np.concatenate(bias_list)
        if len(bcat) != total:
            raise ValueError("pack_pair_queries: one bias per query "
                             "residue")
        rows += upload(bcat.astype(np.int32), dev)[:, None]
        lo, hi = (int(v) for v in torch.aminmax(rows))
        if lo < -127 or hi > 127:
            raise ValueError("pack_pair_queries: profile scores must lie in "
                             "[-127, 127] (int8)")
        # residue j of query q: row j % 16 of stripe q_stripe[q] + j // 16
        j = torch.arange(total, device=dev) - torch.repeat_interleave(
            torch.cumsum(lens_d, 0) - lens_d, lens_d, output_size=total)
        base = ((torch.repeat_interleave(q_stripe_d, lens_d,
                                         output_size=total) + j // STRIPE)
                * (A_PAD * STRIPE) + j % STRIPE)
        col = torch.arange(rows.shape[1], device=dev) * STRIPE
        prof[(base[:, None] + col).reshape(-1)] = rows.reshape(-1).to(
            torch.int8)
    out["prof"] = prof.reshape(-1, A_PAD, STRIPE)
    return out


def pair_profile_plain(letters, q_off, q_stripe, n_stripes, scores,
                       expected, comp_bias: bool = True):
    """Plain PyTorch version of csrc/pair_profile.cu, on the inputs'
    device: (the int8 stripe profile [n_stripes, 32, 16] of the queries
    whose letters lie concatenated in `letters`, query q being
    letters[q_off[q]:q_off[q + 1]] from stripe q_stripe[q] on, each row
    scores[q_i] + bias_i; whether every value lay in [-127, 127]).

    bias_i is sw_bias_i8's composition bias when comp_bias (else 0), in
    the kernel's arithmetic: the window sum over offsets -20..19 in
    integers, then -sum / window length + expected[q_i] in float64, each
    operation rounded on its own, rounded half away from zero."""
    dev = letters.device
    total = letters.numel()
    prof = torch.full((n_stripes * A_PAD * STRIPE,), PROF8_NEG,
                      dtype=torch.int8, device=dev)
    if total == 0:
        return prof.reshape(-1, A_PAD, STRIPE), True
    lens = q_off[1:] - q_off[:-1]
    qid = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                  lens, output_size=total)
    start, n = q_off[:-1][qid], lens[qid]
    i = torch.arange(total, device=dev) - start
    a = letters.long()
    rows = scores.long()[a]                                # [total, alpha]
    bias = torch.zeros(total, dtype=torch.int64, device=dev)
    if comp_bias:
        win_sum = torch.zeros(total, dtype=torch.int64, device=dev)
        for d in range(-20, 20):
            j = i + d
            ok = (j >= 0) & (j < n) & (d != 0)
            nb = letters[torch.where(ok, start + j, 0)].long()
            win_sum += torch.where(ok, rows.gather(1, nb[:, None])[:, 0], 0)
        win_len = torch.minimum(n, i + 20) - torch.clamp_min(i - 20, 0)
        x = (-win_sum.double()) / win_len.double() + expected[a]
        bias = torch.where(x < 0, torch.ceil(x - 0.5),
                           torch.floor(x + 0.5)).long()
    vals = rows + bias[:, None]
    in_range = bool(((vals >= -127) & (vals <= 127)).all())
    base = (q_stripe[qid] + i // STRIPE) * (A_PAD * STRIPE) + i % STRIPE
    col = torch.arange(vals.shape[1], device=dev) * STRIPE
    prof[(base[:, None] + col).reshape(-1)] = vals.reshape(-1).to(torch.int8)
    return prof.reshape(-1, A_PAD, STRIPE), in_range


def pair_profile(letters, q_off, q_stripe, n_stripes, scores, expected,
                 comp_bias: bool = True) -> torch.Tensor:
    """The int8 stripe profile of pair_profile_plain, composition bias
    folded in when comp_bias (inputs: letters uint8 [total], q_off int64
    [n_q + 1], q_stripe int64 [n_q], each query's first stripe in order,
    the queries' stripes not overlapping, as pack_pair_queries lays them
    out; scores int32 [alpha, alpha], expected float64 [alpha]).

    On CUDA tensors this launches csrc/pair_profile.cu once over every
    stripe, which writes every byte of the profile (allocated
    uninitialised), and raises if the kernel cannot be built or launched;
    on CPU tensors it runs pair_profile_plain. Raises ValueError where a
    profile value leaves [-127, 127], or, on a card, where a query letter
    lies outside the matrix's alphabet."""
    dev = letters.device
    if not on_card("pair_profile", letters):
        prof, in_range = pair_profile_plain(letters, q_off, q_stripe,
                                            n_stripes, scores, expected,
                                            comp_bias)
    else:
        for name, x, dtype in (("letters", letters, torch.uint8),
                               ("q_off", q_off, torch.int64),
                               ("q_stripe", q_stripe, torch.int64),
                               ("scores", scores, torch.int32),
                               ("expected", expected, torch.float64)):
            check("pair_profile", name, x, dtype, dev)
        alpha = scores.shape[-1]
        if (scores.dim() != 2 or scores.shape[0] != alpha
                or expected.numel() != alpha or alpha > A_PAD):
            raise ValueError(f"pair_profile: scores must be [alpha, alpha] "
                             f"and expected [alpha], alpha <= {A_PAD}")
        prof = torch.empty((n_stripes, A_PAD, STRIPE), dtype=torch.int8,
                           device=dev)
        flag = 0
        if n_stripes:
            flag_d = torch.empty(1, dtype=torch.int32, device=dev)
            _PROFILE(letters, q_off, q_stripe, q_off.numel() - 1, n_stripes,
                     scores, expected, alpha, int(bool(comp_bias)), prof,
                     flag_d)
            flag = int(flag_d)
        if flag & PROFILE_FLAG_LETTER:
            raise ValueError("pair_profile: query letters must lie in the "
                             "matrix's alphabet")
        in_range = flag == 0
    if not in_range:
        raise ValueError("pair_profile: profile scores must lie in "
                         "[-127, 127] (int8)")
    return prof


def sw_pairs_plain(prof, q_stripe, q_len, t_seqs, t_off, pair_q, pair_t,
                   gap_open: int = 16, gap_extend: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the pair-list kernel: int32 [n] best
    scores in pair order, same inputs, on their device.

    sw_allpairs_plain's column loop over a batch of pairs instead of
    queries x targets: pairs go longest target first in runs of at most
    PLAIN_MAX_ELEMS / (longest query) pairs, each pair's row j reads
    profile row q_stripe * 16 + j (a -128 row past its query's end), and
    columns past a target's end read letter 31 (-128), which cannot raise
    a score (csrc/sw_allpairs.cu)."""
    dev = prof.device
    n = pair_q.numel()
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    pq, pt = pair_q.long(), pair_t.long()
    ql = q_len.long()[pq]
    t0 = t_off[pt]
    tl = t_off[pt + 1] - t0
    lq = int(ql.max())
    if lq == 0 or int(tl.max()) == 0:
        return out
    # profile rows [S * 16, 32] flattened, one -128 row appended for rows
    # past a query's end
    rows = prof.permute(0, 2, 1).reshape(-1, A_PAD).to(torch.int32)
    flat = torch.cat([rows.reshape(-1),
                      torch.full((A_PAD,), PROF8_NEG, dtype=torch.int32,
                                 device=dev)])
    pad_row = rows.shape[0]
    j = torch.arange(lq, device=dev)
    c1 = (gap_extend * (j + 1) - gap_open).to(torch.int32)
    c2 = (gap_extend * j).to(torch.int32)
    order = torch.argsort(tl, descending=True, stable=True)
    chunk = max(1, PLAIN_MAX_ELEMS // lq)
    for c0 in range(0, n, chunk):
        idx = order[c0:c0 + chunk]
        b = idx.numel()
        width = int(tl[idx[0]])
        if width == 0:
            break
        row = q_stripe[pq[idx]][:, None] * STRIPE + j[None, :]
        base = torch.where(j[None, :] < ql[idx][:, None], row,
                           pad_row) * A_PAD                # [b, lq]
        H = torch.zeros((b, lq), dtype=torch.int32, device=dev)
        E = torch.zeros_like(H)
        best = torch.zeros(b, dtype=torch.int32, device=dev)
        zero = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        neg = torch.full((b, 1), NEG, dtype=torch.int32, device=dev)
        for col in range(width):
            inside = col < tl[idx]
            pos = torch.where(inside, t0[idx] + col, 0)
            letter = torch.where(inside, t_seqs[pos].long() & (A_PAD - 1),
                                 PAD_LETTER)
            sub = flat[base + letter[:, None]]
            h_diag = torch.cat([zero, H[:, :-1]], dim=1)
            h_pre = torch.maximum(h_diag + sub, E)
            E = torch.clamp_min(torch.maximum(h_pre - gap_open,
                                              E - gap_extend), 0)
            cm = torch.cummax(h_pre + c1, dim=1).values
            F = torch.cat([neg, cm[:, :-1]], dim=1) - c2
            H = torch.maximum(h_pre, F)
            best = torch.maximum(best, H.amax(dim=1))
        out[idx] = best
    return out


def pair_keys_plain(q_len, t_off, pair_q, pair_t, tail_work: int):
    """Plain PyTorch version of the pair kernel's key pass, on the inputs'
    device: (int16 [n] sort keys, int64 [n] scratch int2s, int64 [2]:
    tail pairs, true cells). A pair whose serial work, stripes x target
    length, reaches tail_work is a tail pair: its key holds TAIL_KEY and
    its work, above every bulk key (stripes, then whether the query has
    more than SHORT_ROWS rows, then target length, each clamped to its
    bits: the order is a matter of speed, never of the scores). A pair
    whose query is longer than one stripe needs a scratch line of its
    target's length, rounded up to LINE_COLS columns."""
    q_lens = q_len.long()[pair_q.long()]
    t = pair_t.long()
    t_lens = t_off[t + 1] - t_off[t]
    stripes = (q_lens + STRIPE - 1) // STRIPE
    work = stripes * t_lens
    tail = work >= tail_work
    key = torch.where(
        tail, TAIL_KEY | work.clamp(max=TAIL_KEY - 1),
        stripes.clamp(max=3) << KEY_LEN_BITS + 1
        | (q_lens > SHORT_ROWS).long() << KEY_LEN_BITS
        | t_lens.clamp(max=(1 << KEY_LEN_BITS) - 1)).to(torch.int16)
    need = torch.where(q_lens > STRIPE,
                       (t_lens + LINE_COLS - 1) // LINE_COLS * LINE_COLS,
                       0)
    return key, need, torch.stack([tail.sum(), (q_lens * t_lens).sum()])


def pair_keys(q_len, t_off, pair_q, pair_t, tail_work: int):
    """pair_keys_plain's (keys, needs, counts) for the pairs (inputs as
    sw_pairs takes them). On CUDA tensors this launches the key pass of
    csrc/sw_allpairs.cu (the counts zeroed by its launcher; one more in
    sw_pairs_keys_launches) and raises if it cannot be built or launched; on
    CPU tensors it runs pair_keys_plain."""
    if not on_card("pair_keys", pair_q):
        return pair_keys_plain(q_len, t_off, pair_q, pair_t, tail_work)
    dev = pair_q.device
    n = pair_q.numel()
    key = torch.empty(n, dtype=torch.int16, device=dev)
    need = torch.empty(n, dtype=torch.int64, device=dev)
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    _PAIR_KEYS(q_len, t_off, pair_q, pair_t, n, tail_work, key, need, stats)
    return key, need, stats


def pair_order(key, need):
    """(order int64 [n]: the pair at each sorted position, tail pairs
    first; end int64 [n]: the running sum of the scratch int2s in that
    order) of pair_keys' keys and needs."""
    order = torch.sort(key, descending=True)[1]
    return order, torch.cumsum(need[order], 0)


def sw_pairs(prof, q_stripe, q_len, t_seqs, t_off, pair_q, pair_t,
             gap_open: int = 16, gap_extend: int = 2) -> torch.Tensor:
    """int32 [n] best SW score of each (pair_q[p], pair_t[p]) pair, in
    pair order (layout: module docstring).

    On CUDA tensors this runs csrc/sw_allpairs.cu's key pass over the
    pairs, sorts its keys (torch.sort, int16) so that the tail pairs, of
    serial work at least PAIR_TAIL_WORK, come first, and launches the
    pair-list entry, which scores the tail a half-warp a pair and the
    bulk a thread a pair in one launch and writes each score at its
    pair's position; it raises if a kernel cannot be built or launched.
    On CPU tensors it runs sw_pairs_plain."""
    if not on_card("sw_pairs", prof):
        return sw_pairs_plain(prof, q_stripe, q_len, t_seqs, t_off, pair_q,
                              pair_t, gap_open, gap_extend)
    dev = prof.device
    for name, x, dtype in (("prof", prof, torch.int8),
                           ("q_stripe", q_stripe, torch.int64),
                           ("q_len", q_len, torch.int32),
                           ("t_seqs", t_seqs, torch.uint8),
                           ("t_off", t_off, torch.int64),
                           ("pair_q", pair_q, torch.int32),
                           ("pair_t", pair_t, torch.int32)):
        check("sw_pairs", name, x, dtype, dev)
    if prof.dim() != 3 or tuple(prof.shape[1:]) != (A_PAD, STRIPE):
        raise ValueError(f"sw_pairs: prof must be [S, {A_PAD}, {STRIPE}]")
    if prof.data_ptr() % 16:
        raise ValueError("sw_pairs: prof must be 16-byte aligned")
    if t_seqs.numel() < int(t_off[-1]) + T_PAD:
        raise ValueError(f"sw_pairs: t_seqs must hold {T_PAD} bytes past "
                         "its last target")
    n = pair_q.numel()
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    key, need, stats = pair_keys(q_len, t_off, pair_q, pair_t,
                                 PAIR_TAIL_WORK)
    order, end = pair_order(key, need)
    n_tail, cells, total = torch.cat([stats, end[-1:]]).tolist()
    # a launch takes the sorted positions whose scratch lines start within
    # one SCRATCH_BYTES budget
    budget = max(1, SCRATCH_BYTES // 8)
    if total <= budget:
        spans, bases, size = [(0, n)], [0], total
    else:
        start = torch.cat([end.new_zeros(1), end[:-1]])
        group = start // budget
        bounds = torch.searchsorted(
            group, torch.arange(int(group[-1]) + 2, device=dev)).tolist()
        spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        first = torch.tensor([a for a, _ in spans], device=dev)
        last = torch.tensor([b - 1 for _, b in spans], device=dev)
        bases, tops = torch.stack([start[first], end[last]]).tolist()
        size = max(t - s for s, t in zip(bases, tops))
    scratch = torch.empty(2 * max(size, 1), dtype=torch.int32, device=dev)
    for (a, b), base in zip(spans, bases):
        _PAIRS(prof, q_stripe, q_len, t_seqs, t_off, pair_q, pair_t,
               order[a:], end[a:], b - a, min(max(n_tail - a, 0), b - a),
               base, gap_open, gap_extend, scratch, out)
    count("pair_cells", cells)
    return out


def pair_targets(t_flat, t_off, device, alphabet: int):
    """(t_seqs uint8 [t_res + T_PAD], t_off int64) on `device`, in one
    upload each: the targets as sw_pairs reads them. Raises if a letter
    lies outside the matrix's `alphabet`."""
    t_flat = np.ascontiguousarray(t_flat, dtype=np.uint8)
    if len(t_flat) and int(t_flat.max()) >= alphabet:
        raise ValueError("device_pair_scores: target letters must lie in "
                         "the matrix's alphabet")
    return (upload(np.concatenate([t_flat, np.zeros(T_PAD, dtype=np.uint8)]),
                   device),
            upload(np.ascontiguousarray(t_off, dtype=np.int64), device))


def device_pair_scores(q_list, biases, t_flat, t_off, cand_t, cand_off,
                       matrix_scores, gap_open: int = 16,
                       gap_extend: int = 2, device="cuda",
                       expected=None, catalog=None) -> np.ndarray:
    """int64 exact SW score of every candidate pair, in pair order: query
    i against target cand_t[p] for p in cand_off[i]:cand_off[i + 1],
    target t being t_flat[t_off[t]:t_off[t + 1]]. The GPU scoring
    engine's entry: the whole target DB and every query's letters go to
    `device` once, the profiles are built there (pack_pair_queries), the
    pairs go in runs of at most PAIR_CHUNK, each scored by sw_pairs.
    biases: one int bias per residue of each query, or None; expected:
    None, or the matrix's expected-score table, with which the profile
    build computes the composition bias itself (biases then None);
    catalog: the SetDB of the targets, under which their copy on `device`
    (pair_targets) is kept in the process's resident store
    (ops/resident.py) and read by later calls, or None to upload them for
    this call. Its steps run in the spans pair_profile, pair_upload,
    pair_score and pair_read_back, none of which synchronises: a step's
    seconds are the host's, up to the read-back, which waits for the
    card."""
    dev = torch.device(device)
    n = len(cand_t)
    out = np.zeros(n, dtype=np.int64)
    if n == 0:
        return out

    def build():
        return pair_targets(t_flat, t_off, dev, matrix_scores.shape[1])

    if catalog is None:
        with span("pair_upload"):
            t_seqs, t_off_d = build()
    else:
        from . import resident
        t_seqs, t_off_d = resident.get(catalog, ("pairs",), dev, build)
    with span("pair_profile"):
        qp = pack_pair_queries(q_list, matrix_scores, biases, dev, expected)
    prof, q_stripe, q_len = qp["prof"], qp["q_stripe"], qp["q_len"]
    cand_off = np.asarray(cand_off, dtype=np.int64)
    for p0 in range(0, n, PAIR_CHUNK):
        p1 = min(n, p0 + PAIR_CHUNK)
        k0 = int(np.searchsorted(cand_off, p0, side="right")) - 1
        k1 = int(np.searchsorted(cand_off, p1, side="left"))
        reps = (np.minimum(cand_off[k0 + 1:k1 + 1], p1)
                - np.maximum(cand_off[k0:k1], p0))
        with span("pair_upload"):
            pair_q = upload(np.repeat(np.arange(k0, k1, dtype=np.int32),
                                      reps), dev)
            pair_t = upload(np.ascontiguousarray(cand_t[p0:p1],
                                                 dtype=np.int32), dev)
        with span("pair_score"):
            scores = sw_pairs(prof, q_stripe, q_len, t_seqs, t_off_d,
                              pair_q, pair_t, gap_open, gap_extend)
        with span("pair_read_back"):
            out[p0:p1] = scores.cpu().numpy()
    return out
