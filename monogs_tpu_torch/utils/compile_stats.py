"""Count the port's native builds and build-cache hits.

Counterpart of ``monogs_tpu/utils/compile_stats.py``. The JAX package
counts XLA compilations and persistent-cache hits from jax's log records;
the port compiles only its native libraries (``_build.py``: the CUDA
kernels by nvcc, the host libraries), each named after the hash of its
sources and flags, so an unchanged library is reused from disk. A cold
start's latency is the builds it runs. ``_build.build_all`` keeps the
record (``BUILT``, ``CACHE_HITS``, ``BUILD_SECONDS``); this class reads the
part of it made while it was installed.

Usage:
    stats = CompileStats.install()
    ... run ...
    stats.uninstall()
    print(stats.summary())
"""

from __future__ import annotations

from collections import Counter

from .. import _build

_RECORD = ("BUILT", "CACHE_HITS", "BUILD_SECONDS")


class CompileStats:
    def __init__(self):
        self._start = self._lengths()
        self._end = None

    @staticmethod
    def _lengths():
        return [len(getattr(_build, k)) for k in _RECORD]

    def _part(self, i):
        end = self._end[i] if self._end is not None else None
        return getattr(_build, _RECORD[i])[self._start[i]:end]

    @classmethod
    def install(cls) -> "CompileStats":
        """Count from now."""
        return cls()

    def uninstall(self):
        """Stop counting (what came before is kept)."""
        if self._end is None:
            self._end = self._lengths()

    @property
    def compiled(self) -> list[str]:
        return [name for name, _ in self._part(0)]

    @property
    def failed(self) -> list[str]:
        return [name for name, rc in self._part(0) if rc != 0]

    @property
    def cache_hits(self) -> list[str]:
        return list(self._part(1))

    @property
    def build_seconds(self) -> float:
        """Wall seconds spent in builds (each batch runs in parallel)."""
        return float(sum(self._part(2)))

    @property
    def n_compiled(self) -> int:
        return len(self.compiled)

    @property
    def n_cache_hits(self) -> int:
        return len(self.cache_hits)

    def hit_rate(self) -> float:
        """Share of the libraries asked for that were already built."""
        tot = self.n_compiled + self.n_cache_hits
        return (self.n_cache_hits / tot) if tot else 0.0

    def summary(self, top: int = 8) -> str:
        names = Counter(self.compiled)
        head = ", ".join(f"{n} x{c}" for n, c in names.most_common(top))
        failed = f"; failed: {', '.join(self.failed)}" if self.failed else ""
        return (f"{self.n_compiled} libraries built in "
                f"{self.build_seconds:.1f} s, {self.n_cache_hits} "
                f"build-cache hits ({100 * self.hit_rate():.0f}%); built: "
                f"{head}{failed}")
