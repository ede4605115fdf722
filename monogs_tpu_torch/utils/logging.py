"""Tagged console logging (counterpart of ``monogs_tpu/utils/logging.py``)."""

from __future__ import annotations

import sys
import time

_START = time.time()


def Log(*args, tag: str = "MonoGS-Torch"):
    msg = " ".join(str(a) for a in args)
    print(f"[{time.time() - _START:9.2f}s][{tag}] {msg}", file=sys.stderr,
          flush=True)
