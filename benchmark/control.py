"""The lower-precision control of a cell's check, at the cell's own size:
the golden model with its data one precision below the configuration's
(the traffic mix's "control": bfloat16 data, since the encoder computes in
float32 whatever it uploads) put in the program's place, on
the image a run of each seed compares, read with the run's own numbers.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed. It runs on the host alone: the benchmark's
runs never run it.
"""
import argparse
import json
import os
import sys


def main(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from jxlbench import spec
    from jxlbench.check import Checker, add_counts, summarize
    from jxlbench.inputs import make_pool, sample

    cell = spec.load_cell(root, args.workload)
    precision = cell.traffic["control"]
    with Checker() as ch:
        for seed in (int(s) for s in args.seeds.split(",")):
            pool = make_pool(root, cell.config, cell.traffic, seed)
            keys = [(i, k) for i, r in enumerate(pool.requests) for k in range(len(r))]
            total = {}
            for i, k in sample(keys, seed, cell.traffic["check"]["answers"]):
                add_counts(total, ch.control(pool.reference_pixels(pool.requests[i][k]),
                                             cell.config["distance"], precision))
            print(json.dumps(dict(workload=args.workload, seed=seed, precision=precision,
                                  **summarize(total), counts=total)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
