#!/usr/bin/env python3
"""The readings that the limits of ``portbench/limits/<cell>.json`` are set
from, for many seeds in one process (the benchmark's own runs never run
this):

    python3 portbench/control.py --workload fcn8s_parity.train --seeds 1,2,3 \
        [--control] [--fault half_batch] [--seconds 51]

For each seed it builds the cell's program side as a run does, plants the
fault if one is named (the mix's ``FAULTS``), drives the checked first
steps, a window of ``--seconds`` (the cell's ``run_seconds`` by default)
and what follows it, frees the program and prints the compared numbers
against the reference as one JSON line. ``--control`` runs the program
with the mix's ``control`` settings: the program's own lower-precision
path, quantization-aware training (int8 grids, ``train.py --qat``) for a
training mix, the int8 Predictor (``--int8``) for a frames mix.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=None,
                   help="the window (default: the cell's run_seconds)")
    args = p.parse_args(argv)

    from portbench.harness import runner

    runner.cache_dirs(ROOT)
    import torch

    unit = runner.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    seconds = unit["bench"]["run_seconds"] if args.seconds is None else args.seconds
    cls = runner.mix_class(ROOT, unit["traffic"]["kind"])
    for seed in (int(s) for s in args.seeds.split(",")):
        mix = cls(torch, unit["cfg"], unit["traffic"], seed,
                  [torch.device("cuda", 0)], control=args.control)
        mix.build()
        if args.fault:
            mix.plant(args.fault)
        mix.first_steps()
        mix.window(seconds)
        mix.after_window()
        mix.release()
        numbers = mix.readings()
        print(json.dumps({"cell": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "seconds": seconds, "readings": numbers,
                          "info": getattr(mix, "info", {})}), flush=True)
        del mix
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
