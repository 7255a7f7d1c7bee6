"""Run one benchmark cell once and print its result line.

    python3 gnnbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or ``python -m gnnbench.run ...``) from the root of a checkout; see
``harness.py``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
# run as a script, Python puts this directory first on the path, where
# trace.py would hide the standard library's module: the checkout instead
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

from gnnbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
