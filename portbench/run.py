#!/usr/bin/env python3
"""The benchmark of spacepharer_tpu_torch (the PyTorch and CUDA port).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. One run:

1. reads the cell from BENCHMARK.json (`workloads`), its configuration
   from portbench/configs/<config>.json and its traffic mix from
   portbench/traffic/<traffic>.json;
2. builds the configuration's catalog, or reuses it: the first run in a
   checkout makes the catalog's genomes (distinct synthetic phage
   genomes, from the configuration's data_seed; portbench/catalog.py)
   and writes under portbench/.cache/<catalog key>/ the target and
   control SetDBs (about 1.4 GB at 8,000 genomes; the genome FASTAs they
   are built from are deleted once the SetDBs are saved), a flat copy of
   the genomes (0.4 GB) and the reference's own table of their ORFs; its
   warm call persists the masked targets of both searches beside them
   (about 0.5 GB). Later runs only read it. The port builds its CUDA
   kernels into spacepharer_tpu_torch/csrc/_build and its native library
   into spacepharer_tpu_torch/native, both inside the checkout;
3. warms up with one whole call on a small batch of the cell's traffic
   (the mix's warm_sets): the dense pass reads the whole catalog at any
   batch size, so every kernel is built and loaded before the window;
4. drives spacepharer_tpu_torch.pipeline.predictmatch.predict_match in a
   closed loop, one whole call at a time, each on a new batch drawn from
   --seed, until --seconds have passed (the last call runs to its end);
5. checks the window's output against the plain reference in
   portbench/reference/ and prints the result as the last line of
   standard output (one JSON object), with every number compared beside
   its limit as the last lines of standard error.

`threads` in the configuration file fixes the host threads of a run
(OMP, BLAS and torch's intra-op pool; the port's native drivers use at
most four), so runs repeat on a shared host.

Data, not code, makes a cell. To add
- a configuration: add portbench/configs/<name>.json (see the two there:
  `predict` holds predictmatch's settings, `catalog` the catalog's
  genome count, length distribution and data seed);
- a traffic mix: add portbench/traffic/<name>.json (sets a call and in
  the warm call, the sizes the sets take in turn, the spacer lengths and
  their counts, the share of spacers that are protospacers and their
  substitution rate), read by portbench/traffic.py;
- a per-layer metric: add portbench/metrics/<name>.py with a function
  `read(record)` that returns the number, or None where the run holds
  nothing to read; an end-to-end metric the same way, as
  portbench/end_to_end/<name>.py.
Then add the entries to BENCHMARK.json. The CPU tests are
`python3 -m pytest -q portbench/tests` (a tiny cell on the port's plain
versions); `python3 portbench/control.py` reads the check's numbers for
the port and for the int4 control at a cell's own size on the card.
"""
import os
import sys
import time

SETUP_T0 = time.perf_counter()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], SETUP_T0))
