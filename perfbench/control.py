"""The controls of the output check, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --mode tf32 --seeds 1,2,3

For each seed it makes the cell's inputs, puts the plain reference in the
program's place computed in ``--mode`` (the step below the configuration's
precision: "tf32" for float32 with TF32 off, "fp8" for bfloat16 storage),
and judges its answers with the cell's own comparison. A sound check reads
``correct: false`` on every seed: the control's numbers are the upper
readings the limits are set below. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from perfbench.harness import run  # noqa: E402
from perfbench.registry import Registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True, choices=("tf32", "fp8"))
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    seconds = Registry(ROOT).bench["run_seconds"]  # the window whose requests are judged
    passed = 0
    for seed in (int(s) for s in a.seeds.split(",")):
        passed += run(ROOT, a.workload, seed, seconds, False, control=a.mode)["correct"]
    return 0 if passed == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
