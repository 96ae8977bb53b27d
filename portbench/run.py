"""The benchmark's entry point, run from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (see
``portbench/harness.py``); exits with another code than 0, printing no
result, when the cell's cards are not there or the run fails.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main, process_start  # noqa: E402

if __name__ == "__main__":
    T_START = process_start()
    sys.exit(main(sys.argv[1:], T_START))
