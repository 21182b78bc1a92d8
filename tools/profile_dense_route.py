#!/usr/bin/env python3
"""Where a fresh `predictmatch` process of the port spends its time, per
prefilter route, under cProfile.

    python3 tools/profile_dense_route.py [--copies 10] [--seed 0] [--top 45]

Builds chip_smoke.py's phase-3 corpus from the golden bundle and --seed
(100 mutated copies of each golden genome; the golden spacers plus 2,000
random sets), repeats its query side --copies times (as chip_smoke.py
phase 3(b) does), and runs `predictmatch` on a fresh copy of the DBs in
a fresh process for the dense route (`--prefilter-engine device
--use-tpu 0`, which needs a CUDA card) and for the host route
(`--use-tpu 0`), each under cProfile. Prints each run's wall, its stage
timers and prefilter statistics, and its functions by cumulative and
by own time; the profiles are written to chiprun_out/<route>_x<copies>.prof.
The control search forks onto the host engine in a child process, which
the profile does not see.
"""
import argparse
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--copies", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=45)
    args = ap.parse_args()
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile_route_") as tmp:
        golden = chip_smoke._golden_dir(tmp)
        paths = chip_smoke.build_corpus(golden, os.path.join(tmp, "p3"),
                                        args.seed)
        src = os.path.dirname(paths["gate"][0])
        corpus = os.path.join(tmp, "corpus")
        shutil.copytree(src, corpus, ignore=shutil.ignore_patterns("query"))
        chip_smoke._gate_queries(os.path.join(src, "query"),
                                 os.path.join(corpus, "query"), args.copies)
        for route, flags in (("dense", ["--prefilter-engine", "device",
                                        "--use-tpu", "0"]),
                             ("host", ["--use-tpu", "0"])):
            run = os.path.join(tmp, route)
            shutil.copytree(corpus, run)
            prof = os.path.join(out_dir, f"{route}_x{args.copies}.prof")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "cProfile", "-o", prof, "-m",
                 "spacepharer_tpu_torch", "predictmatch",
                 *(os.path.join(run, n)
                   for n in ("query", "targets", "targets_rev")),
                 os.path.join(run, "result.tsv"), os.path.join(run, "tmp"),
                 "-v", "2", *flags],
                cwd=REPO, capture_output=True, text=True,
                env=dict(os.environ, SPACEPHARER_PREF_STATS="1"))
            wall = time.perf_counter() - t0
            print(f"== {route} route, query side x{args.copies}, fresh "
                  f"process under cProfile: exit {proc.returncode}, wall "
                  f"{wall:.3f} s")
            if proc.returncode != 0:
                print(proc.stderr[-4000:])
                return 1
            log = (proc.stdout + proc.stderr).splitlines()
            print("\n".join(ln for ln in log if "Time for" in ln
                            or "finalize-batch" in ln
                            or "dense device prefilter" in ln))
            stats = pstats.Stats(prof)
            stats.sort_stats("cumulative").print_stats(args.top)
            stats.sort_stats("tottime").print_stats(args.top // 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
