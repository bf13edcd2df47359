"""One run of one cell: ``python3 cacs_bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``; the last line of standard
output is the result object."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cacs_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
