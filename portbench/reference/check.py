"""The check of a run: what the window's calls produced, against the plain
reference of portbench/reference/, for the sampled spacer set of every
completed call (one with protospacers, drawn from the seed).

Each number compared counts mismatches, so its limit is 0:

  query_orfs       spacers whose ORFs (coordinates, amino acids) differ
                   from the reference's six-frame extraction
  target_orfs      candidate targets whose genome, set, translation or
                   genome's ORF list differ (the reference enumerates
                   every START_TO_STOP ORF of the catalog's genomes
                   once per checkout, when the catalog is built, and
                   compares each candidate genome's list with the
                   port's ORFs of that contig)
  target_masks     sampled candidate targets whose tantan mask differs
  candidates       query ORFs whose dense-prefilter candidate list
                   (target, ungapped score, diagonal, in order) differs
  protein_rows     query ORFs whose protein alignment rows differ
  final_rows       query ORFs whose rows after the nucleotide merge differ
  set_scores       sampled sets whose combined scores (forward or control)
                   differ
  fdr_cut          sets whose rows after the FDR cut differ (all sets of
                   every completed call)
  report_sets      sampled sets whose result.tsv block differs: header
                   lines and hit lines (spacer, phage, P, contig
                   offsets, PAM columns), from the reference's own
                   rows, truncation, offsets and flanks
  checked_calls    completed calls checked; the limit asks for one at least

The prefilter runs on the port's persisted masked catalog (the one stage
taken from the port's state: the reference cannot tantan-mask the whole
catalog within a run); target_masks checks that stage by itself on a
sample. Everything else the reference works out again from the batch's
spacers and the catalog's genomes.
"""
import glob
import os
import re

import numpy as np

from . import align, prefilter, report, seqs, stats

MASK_SAMPLE = 16          # candidate targets per side whose mask is checked
LIMITS = dict(query_orfs=0, target_orfs=0, target_masks=0, candidates=0,
              protein_rows=0, final_rows=0, set_scores=0, fdr_cut=0,
              report_sets=0)


def _masked(db_path):
    found = glob.glob(os.path.join(db_path, "mask_*", "flat_masked.npy"))
    if len(found) != 1:
        raise RuntimeError(f"expected one persisted masked target in "
                           f"{db_path}, found {len(found)}")
    d = os.path.dirname(found[0])
    return (np.load(found[0], mmap_mode="r"),
            np.load(os.path.join(d, "starts.npy")))


class Side:
    """The reference's view of one search's target database."""

    def __init__(self, db, genomes, control, orf_table):
        self.db, self.genomes, self.control = db, genomes, control
        self.orf_table = orf_table
        self.masked, self.starts = _masked(db.path)
        self.residues = int(db.orf_aa_offsets[-1])
        oc = np.asarray(db.orf_contig)
        self._order = np.argsort(oc, kind="stable")
        self._bounds = np.searchsorted(oc[self._order],
                                       np.arange(db.n_contigs + 1))
        self._genome = {}
        self._contig_ok = {}

    def genome_of_contig(self, c):
        """(genome, name, ORF spans, index) of the catalog genome that
        contig c names: the benchmark's own copy of it, and the
        reference's ORF table of it."""
        acc = self.db.contig_accession[c]
        m = re.search(r"_cat(\d+)$", acc)
        g = int(m.group(1)) if m else -1
        if g not in self._genome:
            if 0 <= g < self.genomes.n:
                lo, hi = np.searchsorted(self.orf_table[:, 0], [g, g + 1])
                spans = set(map(tuple, self.orf_table[lo:hi, 1:].tolist()))
                self._genome[g] = (self.genomes.seq(g), self.genomes.name(g),
                                   spans, g)
            else:
                self._genome[g] = (None, None, set(), g)
        return self._genome[g]

    def contig_ok(self, c):
        """Whether contig c is its catalog genome, in that genome's set,
        with the port's ORFs of it exactly the reference's."""
        if c not in self._contig_ok:
            db = self.db
            genome, name, spans, g = self.genome_of_contig(c)
            ks = self._order[self._bounds[c]:self._bounds[c + 1]]
            mine = set(zip(np.asarray(db.orf_from)[ks].tolist(),
                           np.asarray(db.orf_to)[ks].tolist()))
            self._contig_ok[c] = (
                genome is not None and name == db.contig_accession[c]
                and db.set_names[int(db.contig_to_set[c])]
                == f"g{g:05d}.fna.gz"
                and np.array_equal(db.contig_seq(c), genome)
                and mine == spans)
        return self._contig_ok[c]

    def target(self, t):
        """(numeric sequence, nucleotides, ok): the reference's own
        translation of target ORF t from its catalog genome, and whether
        the contig, its ORF list and the port's translation agree."""
        db = self.db
        c = int(db.orf_contig[t])
        genome = self.genome_of_contig(c)[0]
        if genome is None:
            return None, None, False
        f, to = int(db.orf_from[t]), int(db.orf_to[t])
        nucl = seqs.orf_nucl(genome, f, to, self.control)
        aa = seqs.translate(nucl)
        ok = (self.contig_ok(c)
              and aa == bytes(db.orf_aa_data[db.orf_aa_offsets[t]:
                                             db.orf_aa_offsets[t + 1]]))
        return seqs.encode(aa), nucl, ok

    def report_target(self, t):
        """(target set, accession, genome text, contig key, orf_from,
        orf_to) of target ORF t, as the report reads it (checked by
        target())."""
        db = self.db
        c = int(db.orf_contig[t])
        genome, name, _, _ = self.genome_of_contig(c)
        return (int(db.contig_to_set[c]), name, genome.tobytes().decode(), c,
                int(db.orf_from[t]), int(db.orf_to[t]))

    def mask_ok(self, t, q):
        lo, hi = int(self.starts[t]), int(self.starts[t + 1])
        return np.array_equal(seqs.tantan_mask(q),
                              np.asarray(self.masked[lo:hi]))


def _query_side(call):
    """{program key: (numeric aa, nucleotides, (from, to))} of the
    sampled sets' query ORFs, and the number of spacers whose ORFs
    differ."""
    qdb, batch = call["check"]["qdb"], call["batch"]
    sets = set(call["sampled"])
    out, bad = {}, 0
    keys_of = {}
    for k in range(qdb.n_orfs):
        keys_of.setdefault(int(qdb.orf_contig[k]), []).append(k)
    for ci, (_, si, s) in enumerate(batch.spacers):
        if si not in sets:
            continue
        ref = sorted(seqs.spacer_orfs(s))
        mine = sorted((int(qdb.orf_from[k]), int(qdb.orf_to[k]),
                       bytes(qdb.orf_aa_data[qdb.orf_aa_offsets[k]:
                                             qdb.orf_aa_offsets[k + 1]]))
                      for k in keys_of.get(ci, []))
        if ref != mine or int(qdb.contig_to_set[ci]) != si:
            bad += 1
        by_span = {(f, t): aa for f, t, aa in ref}
        for k in keys_of.get(ci, []):
            span = (int(qdb.orf_from[k]), int(qdb.orf_to[k]))
            if span in by_span:
                aa = by_span[span]
                nucl = (s[span[0]:span[1] + 1] if span[0] <= span[1]
                        else seqs.revcomp(s[span[1]:span[0] + 1]))
                out[k] = (seqs.encode(aa), nucl, span)
    return out, bad


# the control: the reference in the port's place with B2's int8 operands
# (the seed scores) quantized to int4, the next type below the int8 that
# the configuration's exact prefilter states (float8 e4m3 holds every
# VTML80 score exactly, so it is no step down here)
def check_run(record, control=False) -> dict:
    """{correct, compared, lines}. With `control` the port's candidate
    lists and rows are replaced by the reference's own, computed from
    int4 seed scores."""
    import time
    import torch
    clock = [time.perf_counter()]
    seconds = {}

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = round(now - clock[0], 3)
        clock[0] = now
    device = record["device"]
    calls = [c for c in record["calls"] + record["extra_calls"] if c["ok"]]
    table = np.load(record["reference_orfs"], mmap_mode="r")
    sides = {"fwd": Side(record["targets"], record["genomes"], False, table),
             "control": Side(record["control"], record["genomes"], True,
                             table)}
    n = dict.fromkeys(LIMITS, 0)
    fdr = float(record["config"]["predict"]["fdr"])
    queries, refs = [], []       # reference queries, (call, key) of each
    per_call = []
    for c in calls:
        qside, bad = _query_side(c)
        n["query_orfs"] += bad
        per_call.append(qside)
        for k, (q, _, _) in sorted(qside.items()):
            queries.append(q)
            refs.append((c["call"], k))
    lap("queries")
    cand, low = {}, {}
    for name, side in sides.items():
        for out, int4 in ((cand, False), (low, True)):
            if int4 and not control:
                continue
            lists = prefilter.candidates(queries, side.masked, side.starts,
                                         device, int4)
            for (ci, k), lst in zip(refs, lists):
                out[(name, ci, k)] = lst
    if device == "cuda":
        torch.cuda.empty_cache()
    lap("prefilter")
    rng = np.random.default_rng([int(record["seed"]) % (1 << 64), 2])
    final = {}
    for name, side in sides.items():
        targets, nucls = {}, {}
        for key, lst in list(cand.items()) + list(low.items()):
            if key[0] != name:
                continue
            for t, _, _ in lst:
                if t not in targets:
                    q, nu, ok = side.target(t)
                    n["target_orfs"] += 0 if ok else 1
                    targets[t] = q if q is not None else np.zeros(0, np.uint8)
                    nucls[t] = nu
        lap(f"targets_{name}")
        sample = sorted(targets)
        if sample:
            for t in rng.choice(sample, min(MASK_SAMPLE, len(sample)),
                                replace=False):
                n["target_masks"] += 0 if side.mask_ok(int(t),
                                                       targets[int(t)]) else 1
        for c, qside in zip(calls, per_call):
            keys = sorted(qside)
            qs = {k: qside[k][0] for k in keys}
            qn = {k: qside[k][1] for k in keys}

            def lists(table):
                return [(k, [t for t, _, _ in table[(name, c["call"], k)]])
                        for k in keys]
            prot, merged = _rows(lists(cand), qs, qn, targets, nucls, side,
                                 device)
            got = c["check"]
            got_cand, got_prot, got_rows = got["cand"], got["prot"], got["rows"]
            if control:
                lp, lm = _rows(lists(low), qs, qn, targets, nucls, side,
                               device)
                got_cand = {(name, k): _columns(low[(name, c["call"], k)])
                            for k in keys}
                got_prot = {(name, k): v for k, v in lp.items()}
                got_rows = {(name, k): v for k, v in lm.items()}
            for k in keys:
                mine = got_cand.get((name, k))
                if mine is None or _triples(mine) != \
                        [tuple(x) for x in cand[(name, c["call"], k)]]:
                    n["candidates"] += 1
                if got_prot.get((name, k)) != prot[k]:
                    n["protein_rows"] += 1
                if got_rows.get((name, k)) != merged[k]:
                    n["final_rows"] += 1
                final[(name, c["call"], k)] = merged[k]
        lap(f"rows_{name}")
    t_sets = {name: side.db.orf_to_set for name, side in sides.items()}
    for c, qside in zip(calls, per_call):
        qdb, got = c["check"]["qdb"], c["check"]
        for qset in c["sampled"]:
            keys = [k for k in sorted(qside)
                    if int(qdb.orf_to_set[k]) == qset]
            for name, table in (("fwd", got["cscore"]),
                                ("control", got["cscore_rev"])):
                best = []
                for k in keys:
                    best += stats.best_hit_per_set(
                        final[(name, c["call"], k)], t_sets[name])
                if table.get(qset) != stats.combine_score(best, len(keys),
                                                          t_sets[name]):
                    n["set_scores"] += 1
        match = stats.fdr_filter(got["cscore"], got["cscore_rev"], fdr)
        for qset in set(match) | set(got["match"]):
            if match.get(qset) != [list(r[:3]) for r in
                                   got["match"].get(qset, [])]:
                n["fdr_cut"] += 1
        n["report_sets"] += _report(c, qside, match, final, sides["fwd"])
    lap("sets")
    n["checked_calls"] = len(calls)
    correct = len(calls) > 0 and all(n[k] <= v for k, v in LIMITS.items())
    compared = {k: {"value": n[k], "limit": LIMITS.get(k, ">= 1")}
                for k in n}
    lines = [f"compared {k}: {n[k]} (limit {LIMITS[k]})" for k in LIMITS]
    lines.append(f"compared checked_calls: {len(calls)} (limit >= 1)")
    return dict(correct=bool(correct), compared=compared, lines=lines,
                seconds=seconds)


def _columns(lst):
    """(targets, scores, diagonals) arrays of a [(t, s, d)] list."""
    a = np.array(lst, dtype=np.int64).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2]


def _triples(cols):
    return [tuple(int(v) for v in x) for x in zip(*cols)]


def _rows(pairs, qs, qn, targets, nucls, side, device):
    """(protein rows, final rows) {key: rows} of the reference."""
    prot = align.protein_rows(pairs, qs, targets, side.residues, device)
    nucl = align.nucleotide_rows({k: r for k, r in prot.items() if r}, qn,
                                 nucls, 3 * side.residues)
    return prot, align.merge_rows(prot, nucl)


def _report(call, qside, match, final, fwd):
    """Sampled sets whose result.tsv block (each header line and the hit
    lines under it) differs from the reference's."""
    qdb, batch = call["check"]["qdb"], call["batch"]
    blocks, cur = {}, None
    for line in call["check"]["text"].splitlines():
        if line.startswith("#"):
            cur = line[1:].split("\t")[0]
        blocks.setdefault(cur, []).append(line)
    by_contig = {}
    for k in sorted(qside):
        by_contig.setdefault(int(qdb.orf_contig[k]), []).append(k)
    bad = 0
    for qset in call["sampled"]:
        spacers = []
        for ci, (head, si, s) in enumerate(batch.spacers):
            if si == qset:
                spacers.append((head, len(s), [
                    qside[k][2] + (final[("fwd", call["call"], k)],)
                    for k in by_contig.get(ci, [])]))
        name = batch.set_names[qset]
        want = report.set_lines(name, spacers, match.get(qset, []),
                                fwd.report_target, fwd.db.orf_to_set)
        if blocks.get(name, []) != want:
            bad += 1
    return bad
