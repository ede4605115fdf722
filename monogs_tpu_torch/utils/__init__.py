"""Host-side utilities: tagged logging, stage timers, profile logs and
device traces, metrics logging, the roofline accounting and the native
build counts."""
from .logging import Log  # noqa: F401
