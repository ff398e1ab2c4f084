"""The benchmark of gs2pc_torch: one run of one cell.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for (it exits with an error, printing no result, without them).  The last
line of standard output is the result as one JSON object; the numbers that
decided ``correct`` are the last lines of standard error.  See
gsbench/harness.py for the run and BENCHMARK.json for the cells.
"""

import os
import sys

if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    ROOT = os.path.dirname(HERE)
    sys.path[:0] = [HERE, ROOT]
    # Build and kernel caches stay at fixed paths inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    from gsbench import harness

    sys.exit(harness.main(sys.argv[1:], ROOT))
