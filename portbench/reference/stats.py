"""The reference set statistics: best hit per target set, the combined
score of a spacer set against a phage, and the FDR cut against the
control search (SpacePHARER's besthitperset, combinescore and
filtermatchbyfdr, as its sources define them). Rows are text fields;
scores are formatted %.3E like the tool's."""
import math
import sys

DBL_MIN = sys.float_info.min
DBL_MAX = sys.float_info.max


def e3(x) -> str:
    return f"{x:.3E}"


def best_hit_per_set(rows, orf_to_set):
    """One query ORF's rows -> one row per target set (ascending set),
    the first row of least E, its column 1 the log-corrected P."""
    groups = {}
    for r in rows:
        groups.setdefault(int(orf_to_set[int(r[0])]), []).append(r)
    out = []
    for _, rs in sorted(groups.items()):
        best_e, best = math.inf, None
        for r in rs:
            e = float(r[3])
            if best_e > e:
                best_e, best = e, r
        if best_e == 0:
            lc = math.log(DBL_MIN)
        elif 0 < best_e < 10e-4:
            lc = math.log(best_e)
        else:
            lc = math.log(1 - math.exp(-best_e))
        row = list(best)
        row[1] = e3(lc)
        out.append(row)
    return out


def combine_score(rows, orf_count, orf_to_set):
    """One query set's merged best-hit rows -> [[set, S_comb, seqId]]:
    the sum of -log P beyond log(1 / (orfCount + 1)) less that threshold,
    or, with none beyond, the last row's -log P (the tool's fallback)."""
    log_thr = math.log(1.0 / (orf_count + 1))
    groups = {}
    for r in rows:
        groups.setdefault(int(orf_to_set[int(r[0])]), []).append(
            (float(r[1]), float(r[2])))
    out = []
    for tset, vals in sorted(groups.items()):
        min_lp = min_sid = sum_lp = sum_sid = 0.0
        k = 0
        for lp, sid in vals:
            if lp < min_lp:
                min_lp, min_sid = (lp if lp == 0 else -lp), sid
            if lp < log_thr:
                sum_lp -= lp - log_thr
                sum_sid += sid
                k += 1
        if k == 0:
            out.append([str(tset), e3(min_lp), e3(min_sid)])
        else:
            out.append([str(tset), e3(sum_lp - log_thr), e3(sum_sid / k)])
    return out


def fdr_threshold(pos_scores, neg_scores, cutoff):
    """The combined-score threshold of FilterMatchbyFdr.cpp: the ROC-like
    curve of the positive scores against the control's, its convex-hull
    slopes, pi0 the mean of the last two, walked to the FDR cutoff."""
    pos = sorted(pos_scores, reverse=True) or [0.0]
    if not neg_scores:
        return pos[-1]
    neg = sorted(neg_scores, reverse=True)
    x, y, uniq = [], [], []
    cur, nc = DBL_MAX, 0
    for pc in range(len(pos)):
        if pos[pc] < cur:
            cur = pos[pc]
            while nc < len(neg) and cur < neg[nc]:
                nc += 1
            uniq.append(cur)
            y.append(pc / len(pos))
            x.append((nc + 0.5) / (len(neg) + 1))
    x.append(1.0)
    y.append(1.0)
    i, slopes, idx = 0, [], []
    while i < len(x) - 1:
        smax, jmax = 0.0, i + 1
        for j in range(i + 1, len(x)):
            dx = x[j] - x[i]
            s = (y[j] - y[i]) / dx if dx != 0 else math.inf
            if s >= smax:
                jmax, smax = j, s
        i = jmax
        slopes.append(smax)
        idx.append(jmax)
    pi0 = (slopes[-2] + slopes[-1]) / 2 if len(slopes) >= 2 else slopes[-1]
    i, fdr = 0, 0.0
    if x[idx[-1]] * pi0 / y[idx[-1]] >= cutoff:
        while fdr <= cutoff:
            fdr = x[idx[i]] * pi0 / y[idx[i]]
            i += 1
    if i < 2:
        return pos[-1]
    j = idx[i - 2]
    tpfp, fp, fdr = y[j], x[j] * pi0, 0.0
    while fdr <= cutoff:
        j += 1
        dx = x[j] - x[j - 1]
        tpfp += dx * slopes[i - 1]
        fp += dx * pi0
        fdr = fp / tpfp
    return uniq[j]


def fdr_filter(pos, neg, cutoff):
    """{qset: kept [set, score, seqId] rows}: rows at or above the
    threshold."""
    thr = fdr_threshold([float(r[1]) for rs in pos.values() for r in rs],
                        [float(r[1]) for rs in neg.values() for r in rs]
                        if neg else [], cutoff)
    return {k: [list(r[:3]) for r in rs if float(r[1]) >= thr]
            for k, rs in pos.items()}
