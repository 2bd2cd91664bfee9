"""The readings that every limit of ``correct`` is set from, for one cell, on
a card: for each seed, one job of the program at the cell's own size and
its compared numbers (the lower readings); for the first ``--control``
seeds, also the control's numbers on the same job (the upper readings):
the plain reference one precision lower (prepare in float32, every product
in TF32), put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... --control 3

One JSON line a seed on standard output. The benchmark's runs do not run
this; ``tests/test_bench_control.py`` holds the control at a small size on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--prepare", choices=("float32", "float64"),
                    default="float32",
                    help="the control's prepare precision (float64: the "
                         "control lowers the products to TF32 alone)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import run as bench_run
    from benchkit import cells, check, generate
    from benchkit.job import Spans
    from cnmf_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda", 0)
    kernel_lib.load_library()
    cell = cells.cell(args.workload)
    counts = generate.counts_for(cell["cfg"], cell["cfg"]["data_seed"], dev)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = bench_run.Run(cell, seed, torch.cuda.get_device_name(dev))
        outs, failed = bench_run.jobs_for(run, cell, counts, dev, 0.0,
                                          Spans(dev))
        line = {"seed": seed, "failed": failed}
        if outs:
            line["program"] = bench_run.check_one(run, cell, counts, outs,
                                                  dev, seed)
            if i < args.control:
                rng = np.random.default_rng([int(seed) % (2 ** 63), 7])
                pick = outs[int(rng.integers(len(outs)))]
                sample = check.sample_restarts(cell, rng)
                seeds = check.restart_seeds(cell["components"],
                                            int(cell["n_iter"]), pick.seed)
                side = check.control_outputs(cell, counts, pick.spectra,
                                             seeds, sample, dev,
                                             np.dtype(args.prepare).type)
                line["control"] = check.compare(cell, counts, side,
                                                pick.spectra, seeds, sample,
                                                dev)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
