"""Run one cell of the benchmark of topk_rec_torch and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
come from BENCHMARK.json. The last line of standard output is the result
as JSON; the compared numbers and their limits are the last lines of
standard error."""

import os
import sys
import time

T_START = time.perf_counter()  # set-up is timed from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
sys.path[0] = ROOT  # the checkout, not this folder

if __name__ == "__main__":
    from portbench.harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
