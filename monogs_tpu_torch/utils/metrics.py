"""Offline metrics logging (counterpart of ``monogs_tpu/utils/metrics.py``).

Metrics go to <save_dir>/metrics.jsonl (one JSON object per ``log`` call,
wandb-style ``{step_metric: ..., **values}``) and a table to
<save_dir>/<name>.json. If wandb is importable and asked for, it is used
as well, in offline mode.
"""

from __future__ import annotations

import json
import os
import threading

_lock = threading.Lock()


class MetricsLogger:
    def __init__(self, save_dir=None, use_wandb=False, run_name="monogs_torch"):
        self.save_dir = save_dir
        self.path = (
            os.path.join(save_dir, "metrics.jsonl") if save_dir else None
        )
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project="MonoGS-Torch", name=run_name, mode="offline"
                )
            except Exception:
                self._wandb = None

    def log(self, values: dict):
        if self.path:
            with _lock, open(self.path, "a") as f:
                f.write(json.dumps(values, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(values)

    def log_table(self, name: str, columns: list, rows: list):
        if self.save_dir:
            with open(
                os.path.join(self.save_dir, f"{name}.json"), "w"
            ) as f:
                json.dump({"columns": columns, "data": rows}, f, indent=2,
                          default=float)
        if self._wandb is not None:
            try:
                import wandb

                self._wandb.log(
                    {name: wandb.Table(columns=columns, data=rows)}
                )
            except Exception:
                pass

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
