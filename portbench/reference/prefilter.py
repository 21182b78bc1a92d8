"""The reference prefilter of a few query ORFs against a whole masked
catalog, in plain PyTorch and NumPy.

MMseqs2's prefilter, as SpacePHARER runs it (k = 6, spaced pattern
11011101, VTML80 at 8 bits for seeds, -s 5.7: k-mer threshold 112,
VTML40 at 2 bits for the ungapped rescoring, --max-seqs 300, minimum
ungapped score 15):

1. a query k-mer row i matches target position j when its seed score
   sum_p S80[q[i + o_p], t[j + o_p]] reaches the row's threshold and j
   holds an indexed k-mer (no X, self score >= 112, inside one ORF); the
   index keeps one position per (k-mer, target ORF), its first;
2. the matches of a query stream out in the index walk's order: row,
   then the similar k-mer's two half ranks (each half list sorted by
   score descending, code ascending), then target ORF; each match gives
   the diagonal (i - j) mod 2^16;
3. the double-diagonal filter, the best ungapped diagonal score per
   target, the histogram cut to 300 and the ordering of the survivors
   (finalize below, after QueryMatcher.cpp and CacheFriendlyOperations).

Step 1 runs as a float16 one-hot product on `device` (every operand and
sum is an integer below 2,048, so it is exact); the rest on the host.
"""
import os

import numpy as np
import torch

from . import seqs

X = seqs.X
N_HALF = 20 ** 3
BLOCK = 1 << 20          # most target positions per product block


def target_valid(flat: torch.Tensor, starts: np.ndarray) -> torch.Tensor:
    """bool [n]: position j starts an indexed k-mer."""
    n = flat.numel()
    dev = flat.device
    scores = torch.from_numpy(seqs.seed_matrix()[0]).to(dev)
    diag = scores.diagonal().to(torch.int32)
    pad = torch.cat([flat.long(), torch.full((seqs.SPAN,), X, device=dev)])
    self_sc = torch.zeros(n, dtype=torch.int32, device=dev)
    no_x = torch.ones(n, dtype=torch.bool, device=dev)
    for o in seqs.OFFSETS:
        col = pad[o:o + n]
        self_sc += diag[col]
        no_x &= col != X
    inside = torch.ones(n, dtype=torch.bool, device=dev)
    ends = torch.from_numpy(np.asarray(starts[1:], dtype=np.int64)).to(dev)
    begins = torch.from_numpy(np.asarray(starts[:-1], dtype=np.int64)).to(dev)
    for o in range(1, seqs.SPAN):
        idx = ends - o
        inside[idx[idx >= begins]] = False
    return (self_sc >= seqs.KMER_THR) & no_x & inside


def dense_hits(queries, flat: torch.Tensor, valid: torch.Tensor,
               int4=False):
    """{query index: (rows, j)} numpy: every (k-mer row position, target
    position) that matches, per query. `int4` quantizes the seed scores
    to 4-bit integers (scale max|S| / 7) first: the control."""
    dev = flat.device
    s80 = seqs.seed_matrix()[0]
    rowq, rowpos, thr, qexp = [], [], [], []
    for qi, q in enumerate(queries):
        pos, t = seqs.kmer_rows(q)
        for p, th in zip(pos, t):
            e = np.zeros(128, dtype=np.float32)
            for k, o in enumerate(seqs.OFFSETS):
                e[k * 21:(k + 1) * 21] = s80[q[p + o], :21]
            qexp.append(e)
            rowq.append(qi)
            rowpos.append(int(p))
            thr.append(int(th))
    out = {qi: ([], []) for qi in range(len(queries))}
    if not qexp:
        return {qi: (np.zeros(0, np.int64), np.zeros(0, np.int64))
                for qi in out}
    dtype = torch.float16 if dev.type == "cuda" else torch.float32
    qm = torch.from_numpy(np.stack(qexp))                         # [R, 128]
    if int4:
        scale = float(np.abs(s80).max()) / 7
        qm = torch.clamp(torch.round(qm / scale), -8, 7) * scale
    qm = qm.to(dev, dtype)
    th = torch.tensor(thr, dtype=torch.float32, device=dev)
    n = flat.numel()
    pad = torch.cat([flat.long(), torch.full((seqs.SPAN,), X, device=dev)])
    rows_i, js = [], []
    block = max(1 << 12, min(BLOCK, (1 << 29) // qm.shape[0]))
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        m = b1 - b0
        onehot = torch.zeros((m, 128), dtype=dtype, device=dev)
        ar = torch.arange(m, device=dev)
        for k, o in enumerate(seqs.OFFSETS):
            onehot[ar, k * 21 + pad[b0 + o:b1 + o]] = 1
        K = (onehot @ qm.T).float()                               # [m, R]
        hit = (K >= th[None, :]) & valid[b0:b1, None]
        j, r = torch.nonzero(hit, as_tuple=True)
        rows_i.append(r.cpu().numpy())
        js.append(j.cpu().numpy() + b0)
    r = np.concatenate(rows_i)
    j = np.concatenate(js)
    rowq = np.asarray(rowq)
    rowpos = np.asarray(rowpos)
    for qi in range(len(queries)):
        sel = rowq[r] == qi
        out[qi] = (rowpos[r[sel]], j[sel])
    return out


def _half_rank(tri, cache):
    key = tuple(int(x) for x in tri)
    r = cache.get(key)
    if r is None:
        s80 = seqs.seed_matrix()[0][:20, :20].astype(np.int64)
        c = np.arange(N_HALF)
        score = (s80[key[0]][c // 400] + s80[key[1]][c // 20 % 20]
                 + s80[key[2]][c % 20])
        order = np.lexsort((c, -score))          # score desc, code asc
        r = np.empty(N_HALF, dtype=np.int64)
        r[order] = np.arange(N_HALF)
        cache[key] = r
    return r


def match_stream(q, pos, j, flat_np, starts, cache):
    """(m_t, m_d) of one query: its matches in the index walk's order,
    one per (row, k-mer, target ORF) at the k-mer's first position."""
    if len(j) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    letters = flat_np[j[:, None] + seqs.OFFSETS[None, :]].astype(np.int64)
    c1 = letters[:, 0] * 400 + letters[:, 1] * 20 + letters[:, 2]
    c2 = letters[:, 3] * 400 + letters[:, 4] * 20 + letters[:, 5]
    seq = np.searchsorted(starts, j, side="right") - 1
    tpos = j - starts[seq]
    r1 = np.empty(len(j), np.int64)
    r2 = np.empty(len(j), np.int64)
    for p in np.unique(pos):
        sel = pos == p
        qo = q[p + seqs.OFFSETS]
        r1[sel] = _half_rank(qo[:3], cache)[c1[sel]]
        r2[sel] = _half_rank(qo[3:], cache)[c2[sel]]
    # first position of each (row, k-mer, ORF), then the walk's order
    order = np.lexsort((tpos, seq, r2, r1, pos))
    pos, r1, r2, seq, tpos = (a[order] for a in (pos, r1, r2, seq, tpos))
    first = np.ones(len(j), dtype=bool)
    first[1:] = ((pos[1:] != pos[:-1]) | (r1[1:] != r1[:-1])
                 | (r2[1:] != r2[:-1]) | (seq[1:] != seq[:-1]))
    return seq[first], (pos[first] - tpos[first]) & 0xFFFF


def l2_cache_size() -> int:
    """The host's L2 cache size (sysconf, else sysfs, else 256 KiB), which
    sets the double-diagonal filter's bin size (QueryMatcher.cpp:383-410)."""
    try:
        v = os.sysconf("SC_LEVEL2_CACHE_SIZE")
        if v > 0:
            return v
    except (ValueError, OSError):
        pass
    try:
        with open("/sys/devices/system/cpu/cpu0/cache/index2/size") as fh:
            txt = fh.read().strip()
        if txt.endswith("K"):
            return int(txt[:-1]) * 1024
        if txt.endswith("M"):
            return int(txt[:-1]) * 1024 * 1024
        return int(txt)
    except (OSError, ValueError):
        return 262144


def bin_bits(n_targets: int) -> int:
    l2 = l2_cache_size()
    for bits in range(1, 12):
        if n_targets // (1 << bits) < l2:
            return bits
    return 11


def ungapped_profile(q, bias80):
    s40 = seqs.sw_matrix()[0]
    corr = seqs.round_half_away(np.asarray(bias80) / 4.0)
    profile = s40[q].astype(np.int64) + corr[:, None]
    u_bias = abs(int(s40.min())) + abs(int(min(corr.min(initial=0), 0)))
    return profile, 255 - u_bias


def diagonal_score(profile, tseq, diag):
    """Best local ungapped segment sum along one diagonal (i - j)."""
    lq, lt = profile.shape[0], len(tseq)
    if diag >= 0:
        if diag >= lq:
            return 0
        n = min(lt, lq - diag)
        sc = profile[diag:diag + n][np.arange(n), tseq[:n]]
    else:
        if -diag >= lt:
            return 0
        n = min(lt + diag, lq)
        sc = profile[:n][np.arange(n), tseq[-diag:-diag + n]]
    c = np.cumsum(sc)
    low = np.minimum.accumulate(np.concatenate([[0], c]))[:-1]
    return int(np.max(c - low, initial=0))


def finalize(m_t, m_d, q, bias80, flat_np, starts, max_seqs=300,
             min_score=15):
    """[(target, score, signed diagonal)] of one query from its stream:
    the double-diagonal filter (targets binned by id, each bin's slots
    shared across bins without reset), the best capped ungapped score per
    target (the first diagonal to reach it wins), the histogram cut to
    max_seqs (ties at the cut by stream order), the saturated branch's
    rescaled scores, sorted by (|score| desc, target asc)."""
    profile, cap = ungapped_profile(q, bias80)
    bits = bin_bits(len(starts) - 1)
    mask = (1 << bits) - 1
    d8 = m_d & 0xFF
    slots, diags, emit = {}, {}, 0
    for b in range(mask + 1):
        sel = np.flatnonzero((m_t & mask) == b)
        if not len(sel):
            continue
        kept = []
        for t, d16, d in zip(m_t[sel].tolist(), m_d[sel].tolist(),
                             d8[sel].tolist()):
            slot = t >> bits
            if slots.get(slot, 0) == d:
                kept.append((t, d16, d))
            slots[slot] = d
        for t, d16, d in reversed(kept):
            slots[t >> bits] = (d + 1) & 0xFF
        for t, d16, d in kept:
            slot = t >> bits
            if slots[slot] != d:
                diags.setdefault(t, []).append((d16, emit))
                emit += 1
            slots[slot] = d
    results = []
    for t, dl in diags.items():
        tseq = flat_np[starts[t]:starts[t + 1]].astype(np.int64)
        best, best_d, best_exact, best_win = -1, 0, 0, 0
        for d16, win in dl:
            sc = diagonal_score(profile, tseq, d16 - 65536 if d16 >= 32768
                                else d16)
            if min(sc, cap) > best:
                best, best_d, best_exact, best_win = min(sc, cap), d16, sc, win
        results.append((t, best, best_d, best_exact, best_win))
    hist = np.zeros(256, dtype=np.int64)
    for r in results:
        hist[min(r[1], 255)] += 1
    found, thr = 0, 0
    for s in range(255, 0, -1):
        found += hist[s]
        if found >= max_seqs:
            thr = s
            break
    thr = max(min_score, thr)
    surv = [r for r in results if r[1] >= thr]

    def signed(d):
        return d - 65536 if d >= 32768 else d
    if thr >= cap:
        self_sc = diagonal_score(profile, np.asarray(q, dtype=np.int64), 0)
        max_self = min(max(self_sc - cap, 1), 65535)
        res = []
        for t, sc, d, exact, win in surv:
            new = (exact - cap) & 0xFFFFFFFF
            f = np.float32(min(new, 65535))
            count8 = int(float(f / np.float32(max_self) * np.float32(255))
                         + 0.5) & 0xFF
            res.append((t, d, count8, win))
        res.sort(key=lambda r: (-r[2], r[3]))
        hits = [(t, cap + (c8 * max_self) // 255, signed(d))
                for t, d, c8, _ in res[:max_seqs]]
    else:
        if len(surv) > max_seqs:
            surv.sort(key=lambda r: (-r[1], r[4]))
            surv = surv[:max_seqs]
        hits = [(t, exact if sc >= cap else sc, signed(d))
                for t, sc, d, exact, _ in surv]
    hits.sort(key=lambda h: (-abs(h[1]), h[0]))
    return hits


def candidates(queries, flat_masked, starts, device, int4=False):
    """[[(target, score, diagonal)]] of each query ORF (numeric, unmasked)
    against the masked catalog (flat uint8, ORF starts); `int4` as
    dense_hits."""
    flat_np = np.array(flat_masked, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    flat = torch.from_numpy(flat_np).to(device)
    valid = target_valid(flat, starts)
    hits = dense_hits(queries, flat, valid, int4)
    del flat, valid
    padded = np.concatenate([flat_np, np.full(seqs.SPAN, X, np.uint8)])
    cache, out = {}, []
    s80, p80, _ = seqs.seed_matrix()
    for qi, q in enumerate(queries):
        pos, j = hits[qi]
        m_t, m_d = match_stream(q, pos, j, padded, starts, cache)
        bias = seqs.local_bias(q, s80, p80)
        out.append(finalize(m_t, m_d, q, bias, flat_np, starts))
    return out
