"""The benchmark's command: one run of one cell on the card.

    python3 -m gvr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. Exits non-zero, printing no result, where there is
no card, where the program is missing, or where JAX or the JAX package was
loaded.
"""

import os
import sys

# a library the port uses must not pull JAX in behind its back
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gvr_bench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
