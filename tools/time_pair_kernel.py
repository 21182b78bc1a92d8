#!/usr/bin/env python3
"""Device time of B1's pair-list entry (sw_pairs) of a checkout of the
port, on chip_smoke.py phase 3's first-search pairs.

    python3 tools/time_pair_kernel.py [--root DIR] [--seed 0] [--calls 10]
                                      [--tail-work W] [--sweep W,...]

Imports spacepharer_tpu_torch from --root (default: this checkout), so
that two versions of csrc/sw_allpairs.cu can be timed on one card in one
call, one process each, in turns: an earlier commit unpacked with `git
archive` under a directory that .gitignore lists, then this checkout. It
builds chip_smoke.py's phase-3 corpus from the golden bundle and --seed,
runs `predictmatch` on it in this process with the GPU scoring engine and
the host prefilter, and keeps the inputs of the first sw_pairs call (the
forward search's candidate pairs). It holds sw_pairs against
sw_pairs_plain on the card on them, prints the distribution of each
pair's serial work (its query's 16-row stripes x its target's length),
then times --calls calls under torch.profiler: the device time of each
kernel of csrc/sw_allpairs.cu that the call runs and their sum, the
wrapper's other device work (named as chip_smoke.py's _kernel_split
names it: "memset", "sort", "other") and the whole call's, beside
chip_smoke.py's bound (_pair_work, _sw_bound) and the card's name and
power limit. The kernels' sum is then timed again on three subsets of
the pairs: those whose work is below W (--tail-work; default the
checkout's sw_packed.PAIR_TAIL_WORK, else 512), those at or above it,
and the single longest pair; and, with --sweep, on all the pairs with
PAIR_TAIL_WORK set to each value given (a checkout that has it). Needs
one CUDA card.
"""
import argparse
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPER_WORK = ("memset", "sort", "other")   # _kernel_split's other names


def first_search_pairs(chip_smoke, sw_packed, tmp, seed):
    """sw_pairs' arguments (prof, q_stripe, q_len, t_seqs, t_off, pair_q,
    pair_t, gap_open, gap_extend) at its first call in phase 3's GPU
    engine run."""
    golden = chip_smoke._golden_dir(tmp)
    calls = []
    pairs = sw_packed.sw_pairs

    def kept(*a):
        calls.append(a[:9])
        return pairs(*a)

    sw_packed.sw_pairs = kept
    try:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            paths = chip_smoke.build_corpus(golden, tmp, seed)
            rc = chip_smoke._cli(
                ["predictmatch", *paths["gpu"], os.path.join(tmp, "gpu.tsv"),
                 os.path.join(tmp, "tmp_gpu"), "--use-tpu", "1",
                 "--prefilter-engine", "host"])
    finally:
        sw_packed.sw_pairs = pairs
    if rc != 0 or not calls:
        raise RuntimeError(f"time_pair_kernel: predictmatch exited {rc} "
                           f"after {len(calls)} sw_pairs calls")
    return calls[0]


def kernel_ms(split):
    """The summed device ms of the pair entry's own kernels in a split."""
    return sum(v for k, v in split.items() if k not in WRAPPER_WORK)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--tail-work", type=int, default=None)
    ap.add_argument("--sweep", default="",
                    help="comma-separated PAIR_TAIL_WORK values to time "
                         "the pair kernels at (checkouts that have it)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)          # the package from root
    import torch
    if not torch.cuda.is_available():
        print("time_pair_kernel: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(      # this checkout's
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from spacepharer_tpu_torch.ops import sw_packed
    if not os.path.abspath(sw_packed.__file__).startswith(root + os.sep):
        raise RuntimeError(f"spacepharer_tpu_torch came from "
                           f"{sw_packed.__file__}, not from {root}")
    tail_work = args.tail_work
    if tail_work is None:
        tail_work = getattr(sw_packed, "PAIR_TAIL_WORK", 512)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory(prefix="pair_kernel_") as tmp:
        p_args = first_search_pairs(chip_smoke, sw_packed, tmp, args.seed)
    got = sw_packed.sw_pairs(*p_args)
    if not torch.equal(got, sw_packed.sw_pairs_plain(*p_args)):
        raise AssertionError("time_pair_kernel: kernel != plain")

    _, q_stripe, q_len, _, t_off, pair_q, pair_t, _, _ = p_args
    t_lens = (t_off[1:] - t_off[:-1])[pair_t.long()]
    stripes = (q_len.long()[pair_q.long()] + sw_packed.STRIPE - 1) \
        // sw_packed.STRIPE
    work = (stripes * t_lens).cpu().numpy()
    top = np.argsort(-work, kind="stable")[:8]
    s_np, t_np = stripes.cpu().numpy(), t_lens.cpu().numpy()
    n_bytes, cells = chip_smoke._pair_work(p_args[:7])
    bound, bound_by = chip_smoke._sw_bound(n_bytes, cells, clock_hz)
    print(f"time_pair_kernel {root}: {len(work)} pairs, {cells} true "
          f"cells, longest target {int(t_lens.max())}, queries over one "
          f"stripe {int((q_len > sw_packed.STRIPE).sum())}; kernel == "
          f"plain; serial work (stripes x target length): quantiles "
          f"50/90/99/99.9/100 % "
          + "/".join(str(int(v)) for v in np.percentile(
              work, [50, 90, 99, 99.9, 100], method="lower"))
          + "; pairs above 256/512/1024/2048: "
          + "/".join(str(int((work > w).sum())) for w in (256, 512, 1024,
                                                          2048))
          + "; the longest (stripes x length): "
          + ", ".join(f"{s_np[i]}x{t_np[i]}" for i in top))

    split = chip_smoke._device_split(sw_packed.sw_pairs, p_args,
                                     args.calls)[0]
    k_ms = kernel_ms(split)
    print(f"time_pair_kernel {root}: device ms per call (torch.profiler, "
          f"{args.calls} calls): "
          + ", ".join(f"{k} {v:.6f}" for k, v in sorted(split.items()))
          + f"; the pair kernels {k_ms:.6f}, the whole call "
          f"{sum(split.values()):.6f}; bound {bound:.6f} ({bound_by}), "
          f"kernel share {bound / k_ms:.4f} ({smi})")

    def subset(mask):
        idx = torch.nonzero(mask).reshape(-1)
        sub = p_args[:5] + (pair_q[idx].contiguous(),
                            pair_t[idx].contiguous()) + p_args[7:]
        return idx.numel(), kernel_ms(chip_smoke._device_split(
            sw_packed.sw_pairs, sub, args.calls)[0])

    w = torch.from_numpy(work).to(pair_q.device)
    longest = torch.zeros_like(w, dtype=torch.bool)
    longest[int(top[0])] = True
    parts = [(f"work < {tail_work}", w < tail_work),
             (f"work >= {tail_work}", w >= tail_work),
             ("the longest pair alone", longest)]
    print(f"time_pair_kernel {root}: the pair kernels' device ms on "
          f"subsets: " + "; ".join(
              f"{name} ({n} pairs) {ms:.6f}" for name, (n, ms) in
              ((name, subset(m)) for name, m in parts if bool(m.any())))
          + f" ({smi})")
    sweep = [int(v) for v in args.sweep.split(",") if v]
    if sweep and hasattr(sw_packed, "PAIR_TAIL_WORK"):
        kept, row = sw_packed.PAIR_TAIL_WORK, []
        try:
            for v in sweep:
                sw_packed.PAIR_TAIL_WORK = v
                row.append((v, int((w >= v).sum()), kernel_ms(
                    chip_smoke._device_split(sw_packed.sw_pairs, p_args,
                                             args.calls)[0])))
        finally:
            sw_packed.PAIR_TAIL_WORK = kept
        print(f"time_pair_kernel {root}: the pair kernels' device ms by "
              f"PAIR_TAIL_WORK (tail pairs): " + "; ".join(
                  f"{v} ({n}) {ms:.6f}" for v, n, ms in row) + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
