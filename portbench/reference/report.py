"""The reference's result.tsv block of one spacer set: SpacePHARER's
truncatebesthits, offsetalignment, convertalis, findpam and
summarizeresults as its sources define them, on the reference's own
rows, coordinates and genomes."""
import math
import re

from . import stats

FLANK = 10
# PAM motifs in the order they are tried (FindPam.cpp, after Leenay and
# Beisel 2017): a 5' motif ends flush at the protospacer, a 3' one starts
# flush at it
_FIVE = [re.compile(p) for p in
         ("[TC]C[ACGT]", "CC[GAT]", "[TC][TC]C", "CC", "A[AT]G", "TT[ACGT]")]
_THREE = [re.compile(p) for p in
          ("[ACGT]GG", "[ACGT][ACGT]AGAA", "[ACGT][ACGT]G[AG][AG]T",
           "[ACGT][ACGT][ACGT][ACGT]G[AT][AT]T")]
_COMP = str.maketrans("ACGTacgtN", "TGCAtgcaN")


def _atoi(s: str) -> int:
    """The leading integer of a string, as C's atoi reads it."""
    m = re.match(r"-?\d*", s)
    return int(m.group(0)) if m.group(0) not in ("", "-") else 0


def _pam(three: str, five: str) -> str:
    f = next((m.group(0) for m in (p.search(five) for p in _FIVE)
              if m and m.end() == FLANK), "-")
    t = next((m.group(0) for m in (p.search(three) for p in _THREE)
              if m and m.start() == 0), "-")
    return f"{f}|{t}"


def _rc(s: str) -> str:
    return s.translate(_COMP)[::-1]


def pam_columns(genome: str, qs, qe, qlen, ts, te):
    """The forward and reverse-complement "5'|3'" PAM columns of a hit at
    0-based contig coordinates (a coordinate pair that runs backwards is
    on the minus strand): the FLANK bases on either side of the
    protospacer, extended over the spacer's unaligned ends; a flank that
    would start before the genome is empty, one that runs past either
    end is cut there."""
    n = len(genome)

    def back(hi, lo):         # complement of positions hi, hi-1, .. lo+1
        return "".join(genome[i] for i in range(hi, lo, -1)
                       if 0 <= i < n).translate(_COMP)
    if (qs <= qe) == (ts <= te):
        if qs <= qe:
            five_end, three_end = ts - qs, te + (qlen - qe)
        else:
            five_end, three_end = te - qe, ts + (qlen - qs)
        five = genome[five_end - FLANK:five_end] if five_end >= FLANK else ""
        three = genome[max(three_end, 0):max(three_end + FLANK, 0)]
    else:
        if qs <= qe:
            five_end, three_end = ts + qs, te - (qlen - qe)
        else:
            five_end, three_end = te + qe, ts - (qlen - qs)
        five = back(five_end + FLANK, five_end)
        three = back(three_end, three_end - FLANK)
    return _pam(three, five), _pam(_rc(five), _rc(three))


def set_lines(set_name, spacers, match, target, orf_to_set):
    """The result.tsv lines of one spacer set.

    spacers: [(accession, length, [(q_from, q_to, final rows)])] in the
    set's order, each spacer's ORFs in key order with their reference
    rows; match: the set's [[target set, S_comb, seqId]] after the FDR
    cut; target(t) -> (target set, accession, genome, contig key,
    orf_from, orf_to) of a target ORF, from the reference's genomes;
    orf_to_set: each target ORF's set, as the statistics read it."""
    orf_count = sum(len(orfs) for _, _, orfs in spacers)
    log_thr = math.log(1.0 / (orf_count + 1))
    rows = []                 # per spacer, sorted as offsetalignment does
    for acc, qlen, orfs in spacers:
        hits = []
        for q_from, q_to, final in orfs:
            for r in stats.best_hit_per_set(final, orf_to_set):
                log_p = float(r[1])
                if log_p >= log_thr:
                    continue
                tset, t_acc, genome, ck, tf, tt = target(int(r[0]))
                ev = float(stats.e3(math.exp(log_p)))
                qs, qe = int(r[4]) * 3, int(r[5]) * 3
                ts, te = int(r[7]) * 3, int(r[8]) * 3
                ts, te = (tf - ts, tf - te - 2) if tf > tt else \
                    (tf + ts, tf + te + 2)
                qs, qe = (q_from - qs, q_from - qe - 2) if q_from > q_to \
                    else (q_from + qs, q_from + qe + 2)
                hits.append(((ev, -_atoi(r[3]), len(genome), ck),
                             (acc, qlen, ev, tset, t_acc, genome,
                              qs, qe, ts, te)))
        rows += [h for _, h in sorted(hits, key=lambda h: h[0])]
    out = []
    for tset, score, _ in match:
        mine = [r for r in rows if r[3] == int(tset)]
        if not mine:
            continue
        out.append("\t".join((f"#{set_name}", mine[0][4], score,
                              str(len(mine)))))
        for acc, qlen, ev, _, t_acc, genome, qs, qe, ts, te in mine:
            fwd, rev = pam_columns(genome, qs, qe, qlen, ts, te)
            out.append("\t".join((f">{acc}", t_acc, f"{ev:.3E}",
                                  str(qs + 1), str(qe + 1), str(ts + 1),
                                  str(te + 1), fwd, rev)))
    return out

