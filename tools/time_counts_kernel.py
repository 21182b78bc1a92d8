#!/usr/bin/env python3
"""Device time of B2's dense pass (csrc/prefilter_dense.cu) of a checkout
of the port, beside its bound.

    python3 tools/time_counts_kernel.py [--root DIR] [--shape phase3]
        [--seed 0] [--calls 5] [--rows 12032] [--tiles 92160]

Imports spacepharer_tpu_torch from --root (default: this checkout), so
that two versions of the kernels can be timed on one card in one call,
one process each, in turns: an earlier commit unpacked with `git archive`
under a directory that .gitignore lists, then this checkout. A package
with prefilter_dense_hits runs its one pass (counts_kernel, which writes
the hits) into a buffer with room for them all; an older one, with
prefilter_dense_counts and prefilter_dense_emit, runs its counts kernel,
the tile listing and its emit kernel, as its match_pairs did. Shapes:
`phase3` builds chip_smoke.py's phase-3 corpus from the golden bundle and
--seed and takes phase 4(b)'s inputs (its query chunk against its whole
masked target); `catalog` makes one launch of the benchmark's dense pass
from --seed: --rows query k-mer rows that can match (random query ORFs,
the default seed matrix and k-mer threshold; 12,032 by default, a
search's rows at the catalog's scale; the warm call's few rows make few
stages) against --tiles target tiles of random letters (92,160 by
default, 47.2 M positions). It compacts the rows once, runs the pass
once to build and warm up, then --calls times with CUDA events around
the launches alone, and prints the mean and each call's ms (and, for the
two kernels, each one's mean), the bound (2 x 128 int8 operations a cell
of the rows that can match over 1,979 TOP/s) and the share, the
launches, the hits and a digest of them as a sorted set (equal digests:
equal hits), and the card's name and power limit. Needs one CUDA card.
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
INT8_OPS_PER_S = 1.979e15


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


def phase3_inputs(pd, seed, dev):
    """(qexp, thr, letters, tval, offsets) of chip_smoke.py phase 4(b)."""
    spec = importlib.util.spec_from_file_location(      # this checkout's
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with tempfile.TemporaryDirectory(prefix="counts_kernel_") as tmp:
        golden = chip_smoke._golden_dir(tmp)
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                paths = chip_smoke.build_corpus(golden, tmp, seed)
            finally:
                sys.stdout = stdout
        params, seed_m, _, _, batch, flat, _, bval = (
            chip_smoke.production_dense_inputs(paths["host"]))
        return pd.dense_inputs(batch, flat, bval, seed_m.scores,
                               params.kmer_threshold(), dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--shape", choices=("phase3", "catalog"),
                    default="phase3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=5)
    ap.add_argument("--rows", type=int, default=12032)
    ap.add_argument("--tiles", type=int, default=92160)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)          # the package from root
    import torch
    if not torch.cuda.is_available():
        print("time_counts_kernel: no CUDA device", file=sys.stderr)
        return 1
    from spacepharer_tpu_torch.logging import timings
    from spacepharer_tpu_torch.ops import prefilter_dense as pd
    if not os.path.abspath(pd.__file__).startswith(root + os.sep):
        raise RuntimeError(f"spacepharer_tpu_torch came from {pd.__file__}, "
                           f"not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.shape == "catalog":
        inputs = catalog_inputs(pd, args.seed, dev, args.rows, args.tiles)
    else:
        inputs = phase3_inputs(pd, args.seed, dev)
    compacted = pd.compact_rows(inputs[0], inputs[1])
    rows = int((inputs[1] <= pd.MAX_K).sum())
    C = inputs[3].numel()
    fused = hasattr(pd, "prefilter_dense_hits")
    if fused:
        counters = ("prefilter_dense_hits_launches",)
        buf = pd.new_hit_buffer(1 << 26, dev)

        def run():
            pd.prefilter_dense_hits(compacted, *inputs[2:], *buf)
            n = int(buf[2].item())
            return buf[0][:n], buf[1][:n]
    else:
        counters = ("prefilter_dense_counts_launches",
                    "prefilter_dense_emit_launches")

        def run():
            counts = pd.prefilter_dense_counts(*inputs, compacted)
            hit = pd.hit_tiles(counts)
            return pd.prefilter_dense_emit(*inputs, *hit, compacted)

    before = [timings().get(c, 0) for c in counters]
    gi, gj = run()
    key = torch.sort(gi.long() * C + gj.long()).values
    digest = hashlib.sha256(key.cpu().numpy().tobytes()).hexdigest()[:16]
    hits = key.numel()
    del key
    pd.launch_events = []
    try:
        for _ in range(args.calls):
            run()
        torch.cuda.synchronize()
        ev = [a.elapsed_time(b) for a, b in pd.launch_events]
    finally:
        pd.launch_events = None
    launches = [timings().get(c, 0) - b for c, b in zip(counters, before)]
    per = len(ev) // args.calls      # launches a call: 1, or counts + emit
    ms = [sum(ev[i * per:(i + 1) * per]) for i in range(args.calls)]
    mean = sum(ms) / len(ms)
    split = "" if per == 1 else " (" + ", ".join(
        f"{name} {sum(ev[k::per]) / args.calls:.4f} ms"
        for k, name in enumerate(("counts", "emit")[:per])) + ")"
    bound = rows * C * 2 * pd.KDIM / INT8_OPS_PER_S * 1e3
    print(f"time_counts_kernel {root} {args.shape}: "
          f"{'fused pass' if fused else 'counts + emit'}; {rows} rows that "
          f"can match ({compacted[0].shape[0]} compacted) x {C} positions; "
          f"kernels alone {mean:.4f} ms{split} ("
          + ", ".join(f"{m:.4f}" for m in ms)
          + f"); bound {bound:.4f} ms (operations); share "
          f"{bound / mean:.4f}; launches {launches}; hits {hits}; hits "
          f"digest {digest} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
