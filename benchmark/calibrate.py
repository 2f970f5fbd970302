"""Readings the limits of ``workloads/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \\
        --modes program,control --seconds 5

runs the cell once per seed and mode in this one process and prints a JSON
line per run with the numbers it compared.  ``program`` is a benchmark run
(its window ``--seconds`` long); ``control`` puts the reference at TF32 in
the port's place; ``fault_half_batch`` (training) puts the reference on half
of each batch in the port's place.  Neither of those builds the port.  Not
part of a benchmark run: the limits' readings are taken with it on the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default="program,control")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            if args.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            r = harness.run(args.workload, seed, args.seconds if mode == "program" else 0.0,
                            False, t0, device=args.device, entry_options={"mode": mode})
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "seconds": time.perf_counter() - t0, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
