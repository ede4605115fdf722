"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see ``harness/cli.py`` for the output). Every
build and kernel cache stays under ``build/`` in the checkout: the port's
nvcc libraries (``build/``), and any torch-extension or Triton cache
(``build/portbench/``), so that only a checkout's first run builds.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    base = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    # a library that would load JAX on its own stays off it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    _environment()
    sys.path.insert(0, ROOT)
    from portbench.harness.cli import main

    sys.exit(main(sys.argv[1:], T0))
