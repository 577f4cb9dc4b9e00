"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see benchmark/README.md).  Every cache that
the run builds stays inside the checkout, under benchmark/_cache/.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import env
    env.setup(ROOT)
    from benchmark.harness import driver
    sys.exit(driver.main(sys.argv[1:], t_start=T_START, root=ROOT))
