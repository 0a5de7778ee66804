"""One run of one cell of the benchmark of arachne_tpu_torch:

    python3 h100_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  See h100_bench/bench.py."""

import os
import sys

# the checkout's root in place of this directory: the package is imported
# as h100_bench, never its modules by their own names
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    from h100_bench.bench import main

    sys.exit(main())
