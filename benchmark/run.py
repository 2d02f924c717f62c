"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of its
standard output (`harness.run`), and each number `correct` compares beside
its limit as the last lines of its standard error.
"""

import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
