#!/usr/bin/env python3
"""Device time of the dense route's stream kernels of a checkout of the
port, at chip_smoke.py phase 4(b)'s shape.

    python3 tools/time_stream_kernels.py [--root DIR] [--seed 0] [--calls 5]

Imports spacepharer_tpu_torch from --root (default: this checkout), so
that two versions of csrc/prefilter_streams.cu can be timed on one card in
one call, one process each, in turns: an earlier commit unpacked with `git
archive` under a directory that .gitignore lists, then this checkout. It
builds chip_smoke.py's phase-3 corpus from the golden bundle and --seed,
runs the dense pass (match_pairs) on phase 4(b)'s query chunk and masked
target, and calls the stream rebuild (rebuild_streams, whose signature
every version shares) once to build and check, then --calls times under
torch.profiler. It prints the device time per call of each kernel of the
rebuild, named as chip_smoke.py's _kernel_split names them (those of
csrc/prefilter_streams.cu by their own names, torch.sort's radix sort as
"sort", memsets as "memset", PyTorch's other kernels as "other"), the
count of stream entries, and the card's name and power limit. Needs one
CUDA card.
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)          # the package from root
    import torch
    if not torch.cuda.is_available():
        print("time_stream_kernels: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(      # this checkout's
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    if not os.path.abspath(pd.__file__).startswith(root + os.sep):
        raise RuntimeError(f"spacepharer_tpu_torch came from {pd.__file__}, "
                           f"not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="stream_kernels_") as tmp:
        golden = chip_smoke._golden_dir(tmp)
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                paths = chip_smoke.build_corpus(golden, tmp, args.seed)
            finally:
                sys.stdout = stdout
        params, seed_m, _, _, batch, flat, starts, bval = (
            chip_smoke.production_dense_inputs(paths["host"]))
        gi, gj = pd.match_pairs(batch, flat, bval, seed_m.scores,
                                params.kmer_threshold(), "cuda")
        entries = len(pd.rebuild_streams(batch, gi, gj, flat, starts,
                                         seed_m.scores)[0])
        torch.cuda.synchronize()
        split = chip_smoke._kernel_split(lambda: [
            pd.rebuild_streams(batch, gi, gj, flat, starts, seed_m.scores)
            for _ in range(args.calls)])
    ms = {k: v / args.calls for k, v in split.items()}
    print(f"time_stream_kernels {root}: {gi.numel()} hits, {entries} stream "
          f"entries; device ms per rebuild (torch.profiler, {args.calls} "
          f"calls): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                  sorted(ms.items())) + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
