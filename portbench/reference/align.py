"""The reference alignment stage: Smith-Waterman of each candidate pair,
E-values, backtraces and result rows; then the nucleotide rescoring
along each protein backtrace and the merge of the two.

Semantics as MMseqs2 runs them for SpacePHARER (VTML40 at 2 bits, gap
open 16 / extend 2, the query's composition bias rounded to integers,
E <= 200; nucleotide.out with gaps 10 / 2): the end cell is the first
target column whose best cell beats every earlier column, at its least
query row; the start cell comes from the same pass over the reversed
prefix; the backtrace is the banded DP of StripedSmithWaterman's
banded_sw with its direction-code ties.

The forward scores run batched over pairs in plain PyTorch on `device`
(int64, exact); backtraces and rows in Python.
"""
import math

import numpy as np
import torch

from . import seqs

GAP_OPEN, GAP_EXTEND, EVALUE = 16, 2, 200.0
NUCL_GAP_OPEN, NUCL_GAP_EXTEND = 10, 2
NEG = -(1 << 40)
# ALP Gumbel parameters (lambda, K, a_J, b_J, a_I, b_I, alpha_J, beta_J,
# alpha_I, beta_I, sigma, tau) of the two scoring systems, as MMseqs2's
# ALP computes them (seed 42)
GUMBEL = {
    "protein": (0.34420393530174209, 0.27487374979561635,
                0.22018895496520485, 0.026237512825550646,
                0.22018895496520485, 0.026237512825550646,
                0.18481499377626534, 1.7126891360391483,
                0.18481499377626534, 1.7126891360391483,
                0.18283871043913499, 1.7838353361758408),
    "nucleotide": (0.63361984397325744, 0.42150719938226583,
                   0.68666204026925159, 0.18923575026627315,
                   0.68666204026925159, 0.18923575026627315,
                   0.71225621255786731, 2.9058945364387716,
                   0.71225621255786731, 2.9058945364387716,
                   0.7125673897037631, 2.8984262849372726),
}


class Evalue:
    """E = K exp(-lambda y) area(y, m, n), area with ALP's finite-size
    correction (sls_pvalues.cpp), m the target database's residues."""

    def __init__(self, system: str, db_residues: int):
        (self.lam, self.K, self.aJ, self.bJ, self.aI, self.bI, self.alJ,
         self.beJ, self.alI, self.beI, self.sigma, self.tau) = GUMBEL[system]
        self.m = float(db_residues)

    @staticmethod
    def _phi(x):
        from scipy.special import erfc
        return 0.5 * erfc(-math.sqrt(0.5) * x)

    def evalue(self, score, n):
        y = np.asarray(score, dtype=np.float64)
        n = np.asarray(n, dtype=np.float64)
        c = 1.0 / math.sqrt(2.0 * math.pi)
        vi_thr = max(2.0 * self.alI / self.lam, 0.0)
        vj_thr = max(2.0 * self.alJ / self.lam, 0.0)
        c_thr = max(2.0 * self.sigma / self.lam, 0.0)
        m_li = self.m - (self.aI * y + self.bI)
        vi = np.maximum(vi_thr, self.alI * y + self.beI)
        svi = np.sqrt(vi)
        with np.errstate(divide="ignore", invalid="ignore"):
            m_f = np.where(svi == 0.0, 1e100, m_li / svi)
        p_m = self._phi(m_f)
        p1 = m_li * p_m - svi * (-c * np.exp(-0.5 * m_f * m_f))
        n_lj = n - (self.aJ * y + self.bJ)
        vj = np.maximum(vj_thr, self.alJ * y + self.beJ)
        svj = np.sqrt(vj)
        with np.errstate(divide="ignore", invalid="ignore"):
            n_f = np.where(svj == 0.0, 1e100, n_lj / svj)
        p_n = self._phi(n_f)
        p2 = n_lj * p_n - svj * (-c * np.exp(-0.5 * n_f * n_f))
        area = p1 * p2 + np.maximum(c_thr, self.sigma * y + self.tau) \
            * p_m * p_n
        return self.K * np.exp(-self.lam * y) * area

    def bits(self, score):
        return (self.lam * np.asarray(score, dtype=np.float64)
                - math.log(self.K)) / math.log(2.0)


def sw_bias(q):
    s40, p40, _ = seqs.sw_matrix()
    return seqs.round_half_away(seqs.local_bias(q, s40, p40))


def forward(profiles, targets, device):
    """(score, t_end, q_end) int64 numpy per pair: the SW end cell of each
    (profile [lq, 21] int, target numeric) pair; t_end -1 where nothing
    scores. H = max(0, diag + S, E, F); E from the cell before F's
    correction; F by a running max along the query."""
    P = len(profiles)
    if P == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    lq = max(len(p) for p in profiles)
    lt = max(len(t) for t in targets)
    prof = np.full((P, lq, 21), NEG // 4, dtype=np.int64)
    tgt = np.zeros((P, lt), dtype=np.int64)
    qlen = np.zeros(P, dtype=np.int64)
    tlen = np.zeros(P, dtype=np.int64)
    for i, (p, t) in enumerate(zip(profiles, targets)):
        prof[i, :len(p)] = p
        tgt[i, :len(t)] = t
        qlen[i], tlen[i] = len(p), len(t)
    dev = torch.device(device)
    prof = torch.from_numpy(prof).to(dev)
    tgt = torch.from_numpy(tgt).to(dev)
    qlen_t = torch.from_numpy(qlen).to(dev)
    tlen_t = torch.from_numpy(tlen).to(dev)
    real = torch.arange(lq, device=dev)[None, :] < qlen_t[:, None]
    H = torch.zeros((P, lq), dtype=torch.int64, device=dev)
    E = torch.zeros_like(H)
    best = torch.zeros(P, dtype=torch.int64, device=dev)
    t_end = torch.full((P,), -1, dtype=torch.int64, device=dev)
    q_end = qlen_t - 1
    j = torch.arange(lq, device=dev)
    ge_j1 = GAP_EXTEND * (j + 1)
    ge_j = GAP_EXTEND * j
    zero_col = torch.zeros((P, 1), dtype=torch.int64, device=dev)
    neg_col = torch.full((P, 1), NEG, dtype=torch.int64, device=dev)
    for i in range(lt):
        sub = torch.gather(prof, 2, tgt[:, i][:, None, None].expand(P, lq, 1)
                           )[:, :, 0]
        h_pre = torch.cat([zero_col, H[:, :-1]], 1) + sub
        h_pre = torch.maximum(torch.maximum(h_pre, E), torch.zeros_like(h_pre))
        E = torch.clamp(torch.maximum(h_pre - GAP_OPEN, E - GAP_EXTEND), min=0)
        cm = torch.cummax(h_pre - GAP_OPEN + ge_j1, 1).values
        F = torch.cat([neg_col, cm[:, :-1]], 1) - ge_j
        h = torch.where(real, torch.maximum(h_pre, F), 0)
        colmax, arg = h.max(1)          # the first row of the maximum
        upd = (colmax > best) & (i < tlen_t)
        best = torch.where(upd, colmax, best)
        t_end = torch.where(upd, torch.full_like(t_end, i), t_end)
        q_end = torch.where(upd, arg, q_end)
        H = h
    return best.cpu().numpy(), t_end.cpu().numpy(), q_end.cpu().numpy()


def banded_backtrace(sub, score):
    """banded_sw over the [start, end] rectangle (sub[target, query]):
    (backtrace of M/I/D, identities are counted by the caller)."""
    db_len, qlen = sub.shape
    band = abs(db_len - qlen) + 1
    while True:
        width = band * 2 + 3
        width_d = band * 2 + 1
        h_b = [0] * (width + 2)
        e_b = [0] * (width + 2)
        h_c = [0] * (width + 2)
        direction = [[0] * (width_d * 3) for _ in range(qlen)]
        maxv = 0
        for i in range(qlen):
            beg, end = max(0, i - band), min(db_len - 1, i + band)
            edge = min(end + 1, width - 1)
            f = h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            dline = direction[i]
            x_i = max(i - band, 0)
            x_p = max(i - 1 - band, 0)
            u = 0
            for jj in range(beg, end + 1):
                u = jj - x_i + 1
                e_idx = jj - x_p + 1
                b_idx = jj - 1 - x_i + 1
                d_idx = jj - 1 - x_p + 1
                de = (jj - x_i) * 3
                t1 = -GAP_OPEN if i == 0 else h_b[e_idx] - GAP_OPEN
                t2 = -GAP_EXTEND if i == 0 else e_b[e_idx] - GAP_EXTEND
                e_b[u] = t1 if t1 > t2 else t2
                dline[de] = 3 if t1 > t2 else 2
                t1 = h_c[b_idx] - GAP_OPEN
                t2 = f - GAP_EXTEND
                f = t1 if t1 > t2 else t2
                dline[de + 1] = 5 if t1 > t2 else 4
                e1 = e_b[u] if e_b[u] > 0 else 0
                f1 = f if f > 0 else 0
                t1 = e1 if e1 > f1 else f1
                t2 = h_b[d_idx] + int(sub[jj, i])
                h_c[u] = t1 if t1 > t2 else t2
                if h_c[u] > maxv:
                    maxv = h_c[u]
                if t1 <= t2:
                    dline[de + 2] = 1
                else:
                    dline[de + 2] = dline[de] if e1 > f1 else dline[de + 1]
            for jj in range(1, u + 1):
                h_b[jj] = h_c[jj]
        if maxv >= score:
            break
        band *= 2
    i, jj, state, ops = qlen - 1, db_len - 1, 2, []
    while i > 0 or jj > 0:
        d = direction[i][(jj - max(0, i - band)) * 3 + state]
        if d == 1:
            i, jj, state = i - 1, jj - 1, 2
            ops.append("M")
        elif d in (2, 3):
            i, state = i - 1, (0 if d == 2 else 2)
            ops.append("I")
        elif d in (4, 5):
            jj, state = jj - 1, (1 if d == 4 else 2)
            ops.append("D")
        else:
            raise RuntimeError("backtrace left the band")
    ops.append("M")
    return "".join(reversed(ops))


def compress(bt: str) -> str:
    out, state, count = [], "M", 0
    for c in bt:
        if c != state:
            out.append(f"{count}{state}")
            state, count = c, 1
        else:
            count += 1
    out.append(f"{count}{state}")
    return "".join(out)


def seq_id_text(f) -> str:
    f = np.float32(f)
    if f == np.float32(1.0):
        return "1.00"
    out = "0."
    if f < np.float32(0.10):
        out += "0"
    if f < np.float32(0.01):
        out += "0"
    return out + str(int(f * np.float32(1000)))


def protein_rows(pairs, queries, targets, db_residues, device):
    """{query index: rows} of the protein alignment: pairs is
    [(query index, [target ids in candidate order])], queries numeric,
    targets {id: numeric unmasked sequence}. Rows are the 11 text fields
    of MMseqs2's alignment result, sorted by (E, -score, target length,
    target id)."""
    s40 = seqs.sw_matrix()[0]
    ev = Evalue("protein", db_residues)
    profs, q_of, t_of, tseqs = [], [], [], []
    bias = {}
    for qi, tids in pairs:
        q = queries[qi]
        if qi not in bias:
            bias[qi] = s40[q].astype(np.int64) + sw_bias(q)[:, None]
        for t in tids:
            profs.append(bias[qi])
            tseqs.append(targets[t])
            q_of.append(qi)
            t_of.append(t)
    score, t_end, q_end = forward(profs, tseqs, device)
    lq = np.array([len(p) for p in profs], dtype=np.int64)
    evals = ev.evalue(score, lq) if len(score) else np.zeros(0)
    keep = np.flatnonzero((t_end >= 0) & (evals <= EVALUE))
    # start cells: the same pass over each survivor's reversed prefix
    rprof = [profs[k][:q_end[k] + 1][::-1] for k in keep]
    rtgt = [tseqs[k][:t_end[k] + 1][::-1] for k in keep]
    rscore, rt_end, rq_end = forward(rprof, rtgt, device)
    out = {qi: [] for qi, _ in pairs}
    staged = {qi: [] for qi, _ in pairs}
    for n, k in enumerate(keep):
        if rscore[n] != score[k]:
            raise RuntimeError("reverse pass disagrees with forward pass")
        te, qe = int(t_end[k]), int(q_end[k])
        ts, qs = te - int(rt_end[n]), qe - int(rq_end[n])
        q = queries[q_of[k]]
        t = tseqs[k]
        sub = profs[k][qs:qe + 1][:, t[ts:te + 1]].T
        bt = banded_backtrace(sub, int(score[k]))
        qp = tp = ids = 0
        for op in bt:
            if op == "M":
                if qp < qe - qs + 1 and tp < te - ts + 1 \
                        and q[qs + qp] == t[ts + tp]:
                    ids += 1
                qp, tp = qp + 1, tp + 1
            elif op == "I":
                qp += 1
            else:
                tp += 1
        sid = float(np.float32(ids / len(bt)))
        row = [str(t_of[k]), str(int(ev.bits(score[k]) + 0.5)),
               seq_id_text(sid), f"{float(evals[k]):.3E}", str(qs),
               str(qe), str(len(q)), str(ts), str(te), str(len(t)),
               compress(bt)]
        staged[q_of[k]].append((float(evals[k]), -int(score[k]), len(t),
                                t_of[k], row))
    for qi, rows in staged.items():
        rows.sort(key=lambda r: r[:4])
        out[qi] = [r[4] for r in rows]
    return out


_NUCL = np.full(256, 4, dtype=np.int64)
for _i, _c in enumerate(b"ACTG"):
    _NUCL[_c] = _i
    _NUCL[_c + 32] = _i
for _c, _d in ((b"U", 2), (b"W", 2), (b"K", 3), (b"B", 3), (b"D", 3),
               (b"V", 3), (b"R", 3), (b"S", 3), (b"M", 1), (b"Y", 1),
               (b"H", 1)):
    _NUCL[_c[0]] = _d
    _NUCL[_c[0] + 32] = _d


def nucl_matrix():
    """nucleotide.out at 1 bit, as MMseqs2's NucleotideMatrix reads it."""
    return seqs.load_matrix("nucleotide.out", 1.0)[0]


def nucleotide_rows(prot, q_nucl, t_nucl, db_nucl_residues):
    """{key: rows} of the nucleotide rescoring of protein rows: each
    protein backtrace walked at 3x over the ORFs' nucleotides, scored
    with nucleotide.out and gaps 10 / 2, E and bits anew."""
    m = nucl_matrix()
    ev = Evalue("nucleotide", db_nucl_residues)
    out = {}
    for key, rows in prot.items():
        out[key] = []
        for row in rows:
            qn = np.asarray(q_nucl[key])
            tn = np.asarray(t_nucl[int(row[0])])
            qc, tc = _NUCL[qn], _NUCL[tn]
            qp, tp = int(row[4]) * 3, int(row[7]) * 3
            q0, t0 = qp, tp
            score = ids = alen = 0
            parts, cnt = [], 0
            for c in row[10]:
                if c.isdigit():
                    cnt = cnt * 10 + int(c)
                    continue
                n = cnt if cnt else 1
                if c == "M":
                    n3 = n * 3
                    ids += int(np.count_nonzero(qn[qp:qp + n3]
                                                == tn[tp:tp + n3]))
                    score += int(m[qc[qp:qp + n3], tc[tp:tp + n3]].sum())
                    qp, tp = qp + n3, tp + n3
                elif c == "D":
                    tp += n * 3
                    score -= NUCL_GAP_OPEN + ((n - 1) * 3) * NUCL_GAP_EXTEND
                else:
                    qp += n * 3
                    score -= NUCL_GAP_OPEN + ((n - 1) * 3) * NUCL_GAP_EXTEND
                alen += n * 3
                parts.append(f"{n * 3}{c}")
                cnt = 0
            e = float(ev.evalue(score, len(qn)))
            sid = np.float32(ids / alen) if alen else np.float32(0)
            out[key].append([row[0], str(int(ev.bits(score))),
                             seq_id_text(float(sid)), f"{e:.3E}", str(q0),
                             str(int(row[5]) * 3 + 2), str(len(qn)), str(t0),
                             str(int(row[8]) * 3 + 2), str(len(tn)),
                             "".join(parts)])
    return out


def merge_rows(prot, nucl):
    """The protein rows with the nucleotide seqId and, where the mean of
    the two log E-values is below the nucleotide one, that mean's E."""
    out = {}
    for key, prows in prot.items():
        by_t = {r[0]: r for r in nucl.get(key, [])}
        rows = []
        for p in prows:
            n = by_t.get(p[0])
            if n is None:
                rows.append([p[0], p[1], "0.000E+00",
                             f"{3.4028234663852886e38:.3E}"] + list(p[4:]))
                continue
            pe, ne = float(p[3]), float(n[3])
            lp = math.log(pe) if pe > 0 else -math.inf
            ln = math.log(ne) if ne > 0 else -math.inf
            mean = lp * 0.5 + ln * 0.5
            e = math.exp(mean) if mean < ln else ne
            rows.append([p[0], p[1], f"{float(n[2]):.3E}", f"{e:.3E}"]
                        + list(p[4:]))
        out[key] = rows
    return out
