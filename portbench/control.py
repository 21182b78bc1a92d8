#!/usr/bin/env python3
"""The two readings that set the check's limits, on the chip at a cell's
own size: for each seed, one window of whole calls on that seed's
batches, checked as a benchmark run checks it (the program) and with the
reference computed from int4 seed scores in the port's place (the
control). One set-up serves every seed. The benchmark's runs never run
this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 10

Prints one JSON line per seed and side: {"seed", "side", "compared"}.
"""
import argparse
import json
import os
import sys
import time

SETUP_T0 = time.perf_counter()


def main(argv, device="cuda", root=None, here=None, cache=None):
    from portbench import cells, harness
    from portbench.reference import check
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    spec = cells.resolve(a.workload, cells.benchmark(root or cells.ROOT),
                         here or harness.HERE)
    harness.pin_environment(spec["config"]["threads"])
    args = harness.parse(["--workload", a.workload, "--seed", str(seeds[0]),
                          "--seconds", str(a.seconds), "--trace", "0"])
    run = harness.Run(args, spec, device, SETUP_T0, cache or harness.CACHE)
    run.setup()
    out = []
    for seed in seeds:
        record = run.window(seed, a.seconds, False)
        for side, control in (("program", False), ("control", True)):
            verdict = check.check_run(record, control=control)
            line = {"seed": seed, "side": side,
                    "correct": verdict["correct"],
                    "compared": {k: v["value"]
                                 for k, v in verdict["compared"].items()}}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1:])
