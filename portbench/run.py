"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload danube-prefill-7680 --seed 7 \\
        --seconds 30 --trace 0

Needs the CUDA cards the cell asks for; exits non-zero without a result
when they are missing, when the program under ``src/`` is missing, or when
the process holds a module of the JAX side once the window has closed.
"""
import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    leaked = harness.leaked_modules()
    if leaked:
        print(f"portbench: the process holds JAX-side modules: {leaked}",
              file=sys.stderr)
        return 4
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
