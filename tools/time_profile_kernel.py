#!/usr/bin/env python3
"""Device time of the GPU scoring engine's profile step (pair_profile) of a
checkout of the port, at chip_smoke.py phase 3's shape.

    python3 tools/time_profile_kernel.py [--root DIR] [--seed 0] [--calls 20]

Imports spacepharer_tpu_torch from --root (default: this checkout), so
that two versions of csrc/pair_profile.cu can be timed on one card in one
call, one process each, in turns: an earlier commit unpacked with `git
archive` under a directory that .gitignore lists, then this checkout. It
builds chip_smoke.py's phase-3 corpus from the golden bundle and --seed,
packs every query ORF of its query side as pack_pair_queries does
(VTML40 at 2 bits, the expected-score table, composition bias on), calls
pair_profile (whose signature every version shares) once to build the
kernel and hold it against pair_profile_plain on the card, then --calls
times under torch.profiler. It prints the device time per call of
everything the step puts on the card, named as chip_smoke.py's
_kernel_split names it (pair_profile_kernel by its own name, memsets as
"memset", PyTorch's other kernels, such as a fill, as "other"), the step's
sum beside chip_smoke.py's bound, and the card's name and power limit.
Needs one CUDA card.
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)          # the package from root
    import torch
    if not torch.cuda.is_available():
        print("time_profile_kernel: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(      # this checkout's
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from spacepharer_tpu_torch.io.setdb import SetDB
    from spacepharer_tpu_torch.ops import sw_packed
    from spacepharer_tpu_torch.ops.bias import expected_score_tab
    from spacepharer_tpu_torch.ops.matrices import load_matrix
    if not os.path.abspath(sw_packed.__file__).startswith(root + os.sep):
        raise RuntimeError(f"spacepharer_tpu_torch came from "
                           f"{sw_packed.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock_hz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]) * 1e6
    with tempfile.TemporaryDirectory(prefix="profile_kernel_") as tmp:
        golden = chip_smoke._golden_dir(tmp)
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                paths = chip_smoke.build_corpus(golden, tmp, args.seed)
            finally:
                sys.stdout = stdout
        qf, qo = (np.array(x) for x in
                  SetDB.load(paths["host"][0]).orf_aa_encoded())
    lens = np.diff(qo).astype(np.int64)
    n_str = (lens + sw_packed.STRIPE - 1) // sw_packed.STRIPE
    q_stripe = np.zeros(len(lens), dtype=np.int64)
    np.cumsum(n_str[:-1], out=q_stripe[1:])
    m40 = load_matrix("VTML40.out", 2.0)
    dev = torch.device("cuda", 0)
    p_args = (torch.from_numpy(np.ascontiguousarray(qf[qo[0]:qo[-1]],
                                                    dtype=np.uint8)).to(dev),
              torch.from_numpy(np.asarray(qo, np.int64) - int(qo[0])).to(dev),
              torch.from_numpy(q_stripe).to(dev), int(n_str.sum()),
              torch.from_numpy(np.ascontiguousarray(m40.scores,
                                                    np.int32)).to(dev),
              torch.from_numpy(expected_score_tab(m40)).to(dev), True)
    got = sw_packed.pair_profile(*p_args)
    want = sw_packed.pair_profile_plain(*p_args)[0]
    if not torch.equal(got, want):
        raise AssertionError("time_profile_kernel: kernel != plain")
    split = chip_smoke._device_split(sw_packed.pair_profile, p_args,
                                     args.calls)[0]
    step = sum(split.values())
    bound, bound_by = chip_smoke._profile_bound(
        chip_smoke._profile_work(p_args), clock_hz)
    print(f"time_profile_kernel {root}: {len(lens)} queries, "
          f"{int(lens.sum())} residues, {int(n_str.sum())} stripes; kernel "
          f"== plain; device ms per call (torch.profiler, {args.calls} "
          f"calls): " + ", ".join(f"{k} {v:.6f}" for k, v in
                                  sorted(split.items()))
          + f"; the step {step:.6f}, bound {bound:.6f} ({bound_by}), share "
          f"{bound / step:.4f} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
