"""Run one cell of the port's benchmark:

    python3 bench_h100/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output; see README.md."""

import sys
import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from bench_h100.harness import main
    sys.exit(main(sys.argv[1:], STARTED))
