"""The card a run measures: its presence, synchronisation, memory and what
the result's ``device`` record says of it; and the check that no JAX
module entered the process."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "monogs_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark must not load,
    compared whole (``monogs_tpu_torch`` is not ``monogs_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Device:
    """``torch.device`` of the run with the calls that differ between the
    card and the CPU (the CPU serves the harness's own tests only)."""

    def __init__(self, torch, kind: str):
        self.torch = torch
        self.dev = torch.device(kind)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_bytes(self) -> int:
        return (int(self.torch.cuda.max_memory_allocated(self.dev))
                if self.cuda else 0)

    def free(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def record(self, count: int) -> dict:
        """The result's ``device`` record (without the peak)."""
        if not self.cuda:
            return dict(platform="cpu", kind="cpu", count=count)
        rec = dict(platform="gpu",
                   kind=self.torch.cuda.get_device_name(self.dev),
                   count=count)
        rec["power_limit_w"] = power_limit()
        return rec

    def count_syncs(self, fn):
        """Host synchronisations that ``fn()`` causes, as the card's sync
        debug mode reports them."""
        import warnings

        if not self.cuda:
            fn()
            return None
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            self.torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                self.torch.cuda.set_sync_debug_mode(0)
        return sum(1 for x in w
                   if str(x.message).startswith("called a synchronizing"))


def power_limit():
    """The card's power limit in watts as nvidia-smi reads it (None where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
