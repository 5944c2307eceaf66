"""Entry point: one run of one benchmark cell (see ``portbench/harness.py``).

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1
"""

import time

T0 = time.perf_counter()  # set-up starts here, before any import

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
