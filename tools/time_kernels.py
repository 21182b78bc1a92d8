#!/usr/bin/env python3
"""Device time of the port's hand-written kernels of a checkout, by
torch.profiler: the port's one clock for a kernel alone.

    python3 tools/time_kernels.py --entry {counts,pairs,profile,streams}
        [...] [--root DIR] [--shape phase3|catalog] [--seed 0] [--calls N]

Imports spacepharer_tpu_torch from --root (default: this checkout), so
that two versions of the kernels can be timed on one card in one call,
one process each, in turns: an earlier commit unpacked with `git archive`
under a directory that .gitignore lists, then this checkout. The inputs
come from this checkout's chip_smoke.py, built from the golden bundle and
--seed (chip_smoke.py phase 3's corpus), every entry's before any is
timed:

  counts   B2's dense pass (prefilter_dense_hits, csrc/prefilter_dense.cu)
           into a buffer with room for every hit: at --shape phase3,
           chip_smoke.py phase 4(b)'s query chunk against its whole
           masked target; at --shape catalog, one launch of the
           benchmark's dense pass from --seed (12,032 query k-mer rows that
           can match, random query ORFs, against 92,160 target tiles of
           random letters); the hits as a sorted set;
  pairs    B1's pair-list entry (sw_pairs, csrc/sw_allpairs.cu) on the
           first sw_pairs call of `predictmatch` with the GPU scoring
           engine and the host prefilter on phase 3's corpus, held
           against sw_pairs_plain on the card; the scores;
  profile  the scoring engine's profile step (pair_profile,
           csrc/pair_profile.cu) on every query ORF of phase 3's query
           side (VTML40 at 2 bits, the expected-score table, composition
           bias on), held against pair_profile_plain; the profile;
  streams  the stream rebuild (rebuild_streams, csrc/prefilter_streams.cu
           and torch.sort) of phase 4(b)'s dense hits; the streams.

Each entry runs once to build and check, then --calls times (default per
entry below) inside one profiler session. It prints the device ms per
call of everything the call put on the card, named as chip_smoke.py's
kernel_split names it (the reader this tool shares with chip_smoke.py),
the entry's kernels' sum, its bound and share where chip_smoke.py has
one, the launches, a digest of the outputs (equal digests: equal
outputs), and the card's name and power limit. Needs one CUDA card.
"""
import argparse
import hashlib
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = ("counts", "pairs", "profile", "streams")
CALLS = {"counts": 5, "pairs": 10, "profile": 20, "streams": 5}
def digest(*arrays):
    """The first 16 hex digits of the SHA-256 of the arrays' bytes."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def catalog_inputs(pd, seed, dev, n_rows=12032, n_tiles=92160):
    """(qexp, thr, letters, tval, offsets) of the catalog shape: n_rows
    rows that can match against n_tiles target tiles."""
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    from spacepharer_tpu_torch.ops.prefilter import PrefilterParams
    params = PrefilterParams()
    seed_m = load_matrix(params.seed_matrix, 8.0)
    rng = np.random.default_rng(seed)
    span = params.pattern_span
    q_all, rows = [], 0
    while rows < n_rows:
        n = min(int(rng.integers(9, 24)), n_rows - rows + span)
        q_all.append(rng.integers(0, 20, n))
        rows += n - span
    batch = pd.build_query_batch(q_all, list(range(len(q_all))),
                                 [np.zeros(len(q)) for q in q_all], params)
    C = n_tiles * pd.TILE_T
    t_flat = rng.integers(0, 20, C).astype(np.uint8)
    return pd.dense_inputs(batch, t_flat, np.ones(C, dtype=bool),
                           seed_m.scores, params.kmer_threshold(), dev)


def first_search_pairs(cs, sw_packed, tmp, paths):
    """sw_pairs' arguments at its first call in `predictmatch` with the
    GPU scoring engine and the host prefilter on phase 3's corpus."""
    import contextlib
    import io
    calls = []
    pairs = sw_packed.sw_pairs

    def kept(*a):
        calls.append(a[:9])
        return pairs(*a)

    sw_packed.sw_pairs = kept
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cs._cli(["predictmatch", *paths["gpu"],
                          os.path.join(tmp, "gpu.tsv"),
                          os.path.join(tmp, "tmp_gpu"), "--use-tpu", "1",
                          "--prefilter-engine", "host"])
    finally:
        sw_packed.sw_pairs = pairs
    if rc != 0 or not calls:
        raise RuntimeError(f"time_kernels: predictmatch exited {rc} after "
                           f"{len(calls)} sw_pairs calls")
    return calls[0]


def profile_args(sw_packed, paths, dev):
    """pair_profile's arguments for every query ORF of phase 3's query
    side, as pack_pair_queries lays them out."""
    import torch
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops.bias import expected_score_tab
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    qf, qo = (np.array(x) for x in SetDB.load(paths["host"][0])
              .orf_aa_encoded())
    lens = np.diff(qo).astype(np.int64)
    n_str = (lens + sw_packed.STRIPE - 1) // sw_packed.STRIPE
    q_stripe = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(n_str[:-1], out=q_stripe[1:])
    m40 = load_matrix("VTML40.out", 2.0)
    put = (lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt))
           .to(dev))
    return (put(qf[qo[0]:qo[-1]], np.uint8),
            put(np.asarray(qo, np.int64) - int(qo[0]), np.int64),
            put(q_stripe, np.int64), int(n_str.sum()),
            put(m40.scores, np.int32), put(expected_score_tab(m40),
                                           np.float64), True)


def build(entries, shape, seed, cs, tmp, dev, clock_hz):
    """{entry: (fn, args, check, bound, names)}: what each entry times on
    `dev`, a function of its output that checks it and returns its digest
    and a description, its (bound ms, by) or None (clock_hz: the card's
    clocks.max.sm), and the device work its sum counts by kernel_split's
    names (None: all of it)."""
    import torch
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    from spacepharer_tpu_torch.ops import sw_packed
    paths = dense = None
    if shape == "phase3" or set(entries) - {"counts"}:
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                paths = cs.build_corpus(cs._golden_dir(tmp), tmp, seed)
            finally:
                sys.stdout = stdout
    if shape == "phase3" and "counts" in entries or "streams" in entries:
        dense = cs.production_dense_inputs(paths["host"])
    out = {}
    if "counts" in entries:
        if shape == "catalog":
            inputs = catalog_inputs(pd, seed, dev)
        else:
            params, seed_m, _, _, batch, flat, _, bval = dense
            inputs = pd.dense_inputs(batch, flat, bval, seed_m.scores,
                                     params.kmer_threshold(), dev)
        compacted = pd.compact_rows(inputs[0], inputs[1])
        rows = int((inputs[1] <= pd.MAX_K).sum())
        C = inputs[3].numel()
        buf = pd.new_hit_buffer(1 << 26, dev)

        def hits(buf=buf):
            n = int(buf[2].item())
            key = torch.sort(buf[0][:n].long() * C + buf[1][:n].long())
            return (digest(key.values.cpu().numpy()),
                    f"{rows} rows that can match ({compacted[0].shape[0]} "
                    f"compacted) x {C} positions, {n} hits")

        out["counts"] = (pd.prefilter_dense_hits,
                         (compacted, *inputs[2:], *buf), lambda _: hits(),
                         cs._bound(0, rows * C * 2 * pd.KDIM,
                                   cs.INT8_OPS_PER_S),
                         ("counts_kernel", "memset"))
    if "pairs" in entries:
        p_args = first_search_pairs(cs, sw_packed, tmp, paths)

        def scores(got, p_args=p_args):
            if not torch.equal(got, sw_packed.sw_pairs_plain(*p_args)):
                raise AssertionError("time_kernels pairs: kernel != plain")
            return (digest(got.cpu().numpy()),
                    f"{got.numel()} pairs, kernel == plain")

        n_bytes, cells = cs._pair_work(p_args[:7])
        out["pairs"] = (sw_packed.sw_pairs, p_args, scores,
                        cs._sw_bound(n_bytes, cells, clock_hz),
                        cs.PAIR_FUNCTIONS)
    if "profile" in entries:
        p_args = profile_args(sw_packed, paths, dev)

        def profile(got, p_args=p_args):
            if not torch.equal(got, sw_packed.pair_profile_plain(*p_args)[0]):
                raise AssertionError("time_kernels profile: kernel != plain")
            return (digest(got.cpu().numpy()),
                    f"{p_args[2].numel()} queries, {p_args[0].numel()} "
                    f"residues, {p_args[3]} stripes, kernel == plain")

        out["profile"] = (sw_packed.pair_profile, p_args, profile,
                          cs._profile_bound(cs._profile_work(p_args),
                                            clock_hz), None)
    if "streams" in entries:
        params, seed_m, _, _, batch, flat, starts, bval = dense
        gi, gj = pd.match_pairs(batch, flat, bval, seed_m.scores,
                                params.kmer_threshold(), dev)

        def streams(got, n=gi.numel()):
            return (digest(*got), f"{n} hits, {len(got[0])} stream entries")

        out["streams"] = (pd.rebuild_streams,
                          (batch, gi, gj, flat, starts, seed_m.scores),
                          streams, None, None)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entry", nargs="+", choices=ENTRIES, required=True)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--shape", choices=("phase3", "catalog"),
                    default="phase3", help="the counts entry's inputs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=None,
                    help=f"timed calls per entry (default {CALLS})")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)          # the package from root
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    if not os.path.abspath(pd.__file__).startswith(root + os.sep):
        raise RuntimeError(f"spacepharer_tpu_torch came from {pd.__file__}, "
                           f"not from {root}")
    spec = importlib.util.spec_from_file_location(      # this checkout's
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory(prefix="time_kernels_") as tmp:
        todo = build(args.entry, args.shape, args.seed, cs, tmp,
                     torch.device("cuda", 0), clock_hz)
    for entry in args.entry:
        fn, f_args, check, bound, names = todo[entry]
        n = args.calls or CALLS[entry]
        before = dict(timings())
        split, got = cs.device_split(fn, f_args, n, names)
        launches = {k: v - before.get(k, 0) for k, v in timings().items()
                    if k.endswith("_launches") and v != before.get(k, 0)}
        dig, what = check(got)
        ms = cs.named_ms(split, names)
        share = ("" if bound is None else f"; bound {bound[0]:.6f} ms "
                 f"({bound[1]}), share {bound[0] / ms:.4f}")
        shape = f" {args.shape}" if entry == "counts" else ""
        print(f"time_kernels {entry}{shape} {root}: {what}; device ms per "
              f"call (torch.profiler, {n} calls, after one warm-up): "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(split.items()))
              + f"; {'+'.join(names or ('all',))} {ms:.6f}{share}; "
              f"launches {launches} ({n + 1} calls); digest {dig} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
