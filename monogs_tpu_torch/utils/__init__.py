"""Host-side utilities: tagged logging, stage timers and profile logs,
metrics logging."""
from .logging import Log  # noqa: F401
