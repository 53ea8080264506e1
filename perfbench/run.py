"""Run one benchmark cell once, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result as one JSON object; the
numbers that decide ``correct`` are the last lines of standard error. It
exits with another code than 0, and prints no result, where no card (or
too few cards) is visible, where a forbidden module is loaded, or where
the program under test is missing.
"""

import os
import sys
import time

T_START = time.monotonic_ns()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench", "cache")
# build and kernel caches at fixed paths inside the checkout, so only a
# cell's first run in a checkout compiles
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# libraries that could load JAX by themselves must not
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT  # the checkout, not perfbench/, whose modules would shadow others

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
