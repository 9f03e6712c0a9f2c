"""Entry point of the benchmark (``BENCHMARK.json``'s command):

    python3 perfbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, and the numbers
the correctness check compared, each beside its limit, as the last lines
of standard error. See ``perfbench/harness.py``."""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, is where ``perfbench`` is found
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
