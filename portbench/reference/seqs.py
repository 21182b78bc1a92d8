"""Plain sequence work of the reference: matrices, ORFs, translation,
composition bias, tantan masking. Written for this benchmark from
SpacePHARER's and MMseqs2's published semantics (the rules the port
states in its docstrings); it imports nothing of the port.
"""
import os
from functools import lru_cache

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
AA = "ACDEFGHIKLMNPQRSTVWYX"
X = 20
_AA_CODE = np.full(256, X, dtype=np.uint8)
for _i, _c in enumerate(AA):
    _AA_CODE[ord(_c)] = _i
# NCBI table 1 in TCAG order
_TABLE1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_TCAG = np.full(256, 4, dtype=np.int64)
for _i, _c in enumerate(b"TCAG"):
    _TCAG[_c] = _i
    _TCAG[_c + 32] = _i
_COMP = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_a] = _b
SPAN = 8
OFFSETS = np.array([0, 1, 3, 4, 5, 7])      # spaced pattern 11011101
KMER_THR = 112                              # -s 5.7, k = 6
MAX_K = 6 * 127                             # no int8 row scores higher


def encode(aa_ascii) -> np.ndarray:
    return _AA_CODE[np.frombuffer(bytes(aa_ascii), dtype=np.uint8)]


@lru_cache(maxsize=None)
def load_matrix(name: str, bit_factor: float):
    """(scores int32 [21, 21], p_back float64 [21], prob float64 [21, 21])
    of a .out matrix at a bit factor: probabilities from the file's
    scores, lambda and background (p scaled by 1 - p_X where X scores
    are not positive), rescaled by the row-sum background with X at 1e-5
    and rounded half away from zero."""
    alphabet, rows, lam, p = None, {}, None, None
    with open(os.path.join(HERE, name)) as fh:
        for line in fh:
            if line.startswith("#"):
                if line.startswith("# Background (precomputed optional):"):
                    p = np.array([float(x) for x in line.split(":")[1].split()])
                elif line.startswith("# Lambda     (precomputed optional):"):
                    lam = float(line.split(":")[1].split()[0])
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            if alphabet is None:
                alphabet = "".join(x[0].upper() for x in parts)
                continue
            rows[parts[0].upper()] = [float(x) for x in parts[1:]]
    a = len(alphabet)
    s = np.array([rows[c] for c in alphabet], dtype=np.float64)
    x = alphabet.index("X")
    p = p.copy()
    if not ((s[x, :] > 0).any() or (s[:, x] > 0).any()):
        keep = np.arange(a) != x
        p[keep] *= 1.0 - p[x]
    prob = np.exp(lam * s) * p[:, None] * p[None, :]
    p2 = prob.sum(axis=1)
    p2[a - 1] = 1e-5
    with np.errstate(divide="ignore"):
        f = bit_factor * np.log2(prob / (p2[:, None] * p2[None, :]))
    scores = np.where(f < 0.0, f - 0.5, f + 0.5).astype(np.int32)
    return scores, p, prob


def seed_matrix():
    return load_matrix("VTML80.out", 8.0)


def sw_matrix():
    return load_matrix("VTML40.out", 2.0)


def round_half_away(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x < 0, np.ceil(x - 0.5), np.floor(x + 0.5)).astype(np.int64)


def local_bias(q: np.ndarray, scores: np.ndarray, p_back: np.ndarray):
    """Composition bias per position (window of 40 centred on it):
    -(sum of S[q_i][q_j] over the window but j = i) / window length +
    sum_a p(a) S[q_i][a]."""
    n = len(q)
    if n == 0:
        return np.zeros(0)
    s = scores.astype(np.float64)
    q = np.asarray(q, dtype=np.int64)
    rows = s[q]
    win = np.zeros(n)
    i = np.arange(n)
    for d in range(-20, 20):
        j = i + d
        ok = (j >= 0) & (j < n)
        win[ok] += rows[i[ok], q[j[ok]]]
    wlen = (np.minimum(n, i + 20) - np.maximum(0, i - 20)).astype(np.float64)
    win -= rows[i, q]
    expected = (scores.astype(np.float64) @ p_back)[q]
    return -win / wlen + expected


def kmer_rows(q: np.ndarray):
    """(positions, thresholds) of the k-mers of a query ORF that seek
    matches: every start whose 8-residue span fits, but the last one, with
    no X at the spaced offsets; threshold max(112 - bias sum, 0)."""
    scores, p_back, _ = seed_matrix()
    n = len(q) - SPAN
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pos = np.arange(n)
    ok = np.ones(n, dtype=bool)
    for o in OFFSETS:
        ok &= q[pos + o] != X
    pos = pos[ok]
    bias = local_bias(q, scores, p_back)
    kb = round_half_away(bias[pos[:, None] + OFFSETS[None, :]].sum(axis=1))
    return pos, np.maximum(KMER_THR - kb, 0)


def translate(nucl: np.ndarray) -> bytes:
    n = len(nucl) // 3
    c = _TCAG[nucl[:3 * n]].reshape(n, 3)
    bad = (c == 4).any(axis=1)
    idx = np.where(bad, 0, c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2])
    aa = np.frombuffer(_TABLE1.encode(), np.uint8)[idx]
    return np.where(bad, ord("X"), aa).astype(np.uint8).tobytes()


def revcomp(nucl: np.ndarray) -> np.ndarray:
    return _COMP[np.asarray(nucl)[::-1]]


def reverse_codons(nucl: np.ndarray) -> np.ndarray:
    n = len(nucl) // 3 * 3
    return np.asarray(nucl)[len(nucl) - n:].reshape(-1, 3)[::-1].reshape(-1)


def _stops(strand: np.ndarray, f: int):
    n = (len(strand) - f) // 3
    c = _TCAG[strand[f:f + 3 * n]].reshape(n, 3)
    codon = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
    stop = np.frombuffer(_TABLE1.encode(), np.uint8)[
        np.where((c == 4).any(axis=1), 0, codon)] == ord("*")
    return n, stop & ~(c == 4).any(axis=1), codon


def spacer_orfs(seq: np.ndarray, min_codons: int = 9) -> list:
    """[(contig_from, contig_to, aa bytes)] of a spacer: every run of
    codons between stops of each of the six frames (a run may start at the
    frame's first codon and end at its last whole one) of at least
    min_codons codons; minus-strand coordinates run from > to."""
    out = []
    L = len(seq)
    for strand_sign, strand in ((1, np.asarray(seq)), (-1, revcomp(seq))):
        for f in range(3):
            n, stop, _ = _stops(strand, f)
            if n <= 0:
                continue
            bounds = np.concatenate(([-1], np.flatnonzero(stop), [n]))
            for a, b in zip(bounds[:-1], bounds[1:]):
                s0, s1 = a + 1, b          # codons s0 .. s1 - 1
                if s1 - s0 < min_codons:
                    continue
                p0, p1 = f + 3 * s0, f + 3 * s1 - 1
                aa = translate(strand[p0:p1 + 1])
                if strand_sign > 0:
                    out.append((p0, p1, aa))
                else:
                    out.append((L - 1 - p0, L - 1 - p1, aa))
    return out


def orf_nucl(contig: np.ndarray, c_from: int, c_to: int, control: bool):
    """The reading-direction nucleotides of an ORF at contig coordinates
    (minus strand: from > to), codon-reversed for the control."""
    if c_from <= c_to:
        s = np.asarray(contig[c_from:c_to + 1])
    else:
        s = revcomp(contig[c_to:c_from + 1])
    return reverse_codons(s) if control else s


def genome_orfs(contig: np.ndarray, min_codons: int = 30) -> set:
    """{(contig_from, contig_to)} of a target genome's START_TO_STOP ORFs:
    in each of the six frames, each run of codons between stops, from its
    first ATG (from the frame's first codon where no stop precedes it) to
    the codon before the next stop (the frame's last whole codon where
    none follows), of at least min_codons codons; minus-strand
    coordinates run from > to."""
    out = set()
    L = len(contig)
    atg = 2 * 16 + 0 * 4 + 3          # A T G in TCAG digits (T0 C1 A2 G3)
    for minus, strand in ((False, np.asarray(contig)),
                          (True, revcomp(contig))):
        for f in range(3):
            n, stop, codon = _stops(strand, f)
            if n <= 0:
                continue
            ends = np.concatenate((np.flatnonzero(stop), [n]))
            starts = np.concatenate(([-1], ends[:-1])) + 1
            atgs = np.flatnonzero(codon == atg)
            first = np.searchsorted(atgs, starts)
            first_atg = np.append(atgs, n)[first]
            s0 = np.where(np.arange(len(starts)) == 0, 0, first_atg)
            keep = (s0 < ends) & (ends - s0 >= min_codons)
            p0 = f + 3 * s0[keep]
            p1 = f + 3 * ends[keep] - 1
            if minus:
                p0, p1 = L - 1 - p0, L - 1 - p1
            out.update(zip(p0.tolist(), p1.tolist()))
    return out


def orf_table(per_genome: list) -> np.ndarray:
    """int64 [n, 3] (genome, contig_from, contig_to) of every genome's
    ORFs (genome_orfs of genome g at per_genome[g]), sorted."""
    rows = [np.array(sorted(spans), dtype=np.int64).reshape(-1, 2)
            for spans in per_genome]
    g = np.repeat(np.arange(len(rows)), [len(r) for r in rows])
    return np.column_stack((g, np.concatenate(rows)))


def rows_that_can_match(batch) -> int:
    """The dense prefilter's work rows of a batch: k-mer rows of every
    query ORF (kmer_rows) whose threshold an int8 row score can reach."""
    total = 0
    for _, _, s in batch.spacers:
        for _, _, aa in spacer_orfs(s):
            _, thr = kmer_rows(encode(aa))
            total += int((thr <= MAX_K).sum())
    return total


# ---- tantan (Frith 2011), no-gap model, as the prefilter's index build
# masks targets: 50 repeat offsets, repeat 0.005, end 0.05, decay 0.9,
# rescaled every 16 positions, positions of P(repeat) >= 0.9 masked

def repeat_probabilities(q: np.ndarray, ratios: np.ndarray) -> np.ndarray:
    n, max_off, step = len(q), 50, 16
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    b2b, f2b, f2f0 = 1.0 - 0.005, 0.05, 1.0 - 0.05
    b2f = 0.005 * (1 - 0.9) / (1 - 0.9 ** max_off) * 0.9 ** np.arange(max_off)
    q = np.asarray(q, dtype=np.int64)
    fg = np.zeros(max_off)
    bg = 1.0
    probs = np.zeros(n, dtype=np.float32)
    scales = np.zeros(n // step)
    for t in range(n):
        m = min(t, max_off)
        if m > 0:
            em = ratios[q[t], q[t - 1 - np.arange(m)]]
            from_fg = fg[:m].sum()
            fg[:m] = (bg * b2f[:m] + fg[:m] * f2f0) * em
        else:
            from_fg = 0.0
        bg = bg * b2b + from_fg * f2b
        if t % step == step - 1:
            scale = 1.0 / bg
            scales[t // step] = scale
            bg *= scale
            fg *= scale
        probs[t] = np.float32(bg)
    z = bg * b2b + fg.sum() * f2b
    bg = b2b
    fg = np.full(max_off, f2b)
    for t in range(n - 1, -1, -1):
        probs[t] = np.float32(1.0) - np.float32(np.float64(probs[t]) * bg / z)
        if t % step == step - 1:
            bg *= scales[t // step]
            fg *= scales[t // step]
        m = min(t, max_off)
        to_bg = f2b * bg
        if m > 0:
            em = ratios[q[t], q[t - 1 - np.arange(m)]]
            femit = fg[:m] * em
            to_fg = (b2f[:m] * femit).sum()
            fg[:m] = to_bg + f2f0 * femit
        else:
            to_fg = 0.0
        bg = b2b * bg + to_fg
    return probs


def tantan_mask(q: np.ndarray) -> np.ndarray:
    """q with its repeat positions set to X."""
    _, p, prob = seed_matrix()
    ratios = prob / (p[:, None] * p[None, :])
    out = np.asarray(q, dtype=np.uint8).copy()
    out[repeat_probabilities(q, ratios) >= np.float32(0.9)] = X
    return out
