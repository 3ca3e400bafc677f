"""The readings that a cell's limits are set from, in one process: the
program's check numbers over many seeds and the fp8 control's over a few,
each through a short window at the cell's own load (``harness.run``).

    python3 portbench/readings.py --workload danube-prefill-7680 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 \\
        --out readings.jsonl

Prints one JSON line a run: the seed, whether it was the control, the check
numbers and the run's end-to-end metrics.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, program, spec

    if not torch.cuda.is_available():
        print("readings: needs a CUDA card", file=sys.stderr)
        return 3
    program.import_port()
    cell = spec.cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in runs:
            t = time.time()
            r = harness.run(cell, seed, args.seconds, False, "cuda", t,
                            control=control)
            line = json.dumps({
                "workload": args.workload, "seed": seed, "control": control,
                "numbers": {k: v["value"] for k, v in r["check"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "info": r["info"], "memory_peak_bytes":
                r["device"]["memory_peak_bytes"], "run_s": time.time() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del r
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
