"""Training-metrics logging: a multi-backend logger multiplexer.

The counterpart of ``bitorch_engine_tpu/utils/metrics.py`` (the port keeps
its own copy: it imports nothing of the JAX package).  Loggers receive
``{name: value}`` dicts whose values are numbers or scalar torch tensors;
each is logged as ``float(value)``.  ``float()`` of a tensor on the card
waits for the device, so log at step boundaries, not inside the hot loop.

Backends: CSV file, JSON-lines file, stdout, and (when the package is
importable) Weights & Biases.  ``MetricsLogger`` fans out to any set of
them.
"""

from __future__ import annotations

import csv
import json
import os
import sys
import time
from typing import Dict, Iterable, Optional


class CSVLogger:
    """Append metrics to ``<dir>/metrics.csv`` (header grows as new metric
    names appear; rows are rewritten with the union header when it grows,
    like Lightning's CSVLogger)."""

    def __init__(self, log_dir: str, filename: str = "metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._fields = ["step", "time"]
        self._started = False

    def log(self, metrics: Dict[str, float], step: int):
        """Appends one row; the file is only rewritten when a new metric key
        widens the header (O(header-growth events), not O(steps²) — rows are
        not kept in memory)."""
        row = {"step": step, "time": round(time.time(), 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        new_fields = [k for k in row if k not in self._fields]
        if new_fields and self._started:
            self._fields.extend(new_fields)
            with open(self.path, newline="") as f:
                old_rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields, restval="")
                w.writeheader()
                w.writerows(old_rows)
        elif new_fields:
            self._fields.extend(new_fields)
        mode = "a" if self._started else "w"
        with open(self.path, mode, newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, restval="")
            if not self._started:
                w.writeheader()
            w.writerow(row)
        self._started = True

    def finalize(self):
        pass


class JSONLLogger:
    """One JSON object per line."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a")

    def log(self, metrics: Dict[str, float], step: int):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def finalize(self):
        self._f.close()


class StdoutLogger:
    """Print-based logging — the reference library's own style
    (``train_mnist.py:94-97``)."""

    def __init__(self, stream=None, every: int = 1):
        self.stream = stream or sys.stderr
        self.every = max(1, every)

    def log(self, metrics: Dict[str, float], step: int):
        if step % self.every:
            return
        body = " ".join(f"{k} {float(v):.4f}" for k, v in metrics.items())
        print(f"step {step}: {body}", file=self.stream, flush=True)

    def finalize(self):
        pass


class WandbLogger:
    """Weights & Biases backend; raises ``ImportError`` when ``wandb`` is
    not installed."""

    def __init__(self, project: str, run_name: Optional[str] = None, **init_kw):
        try:
            import wandb  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "wandb is not installed; use CSVLogger/JSONLLogger instead"
            ) from e
        import wandb

        self._run = wandb.init(project=project, name=run_name, **init_kw)

    def log(self, metrics: Dict[str, float], step: int):
        self._run.log({k: float(v) for k, v in metrics.items()}, step=step)

    def finalize(self):
        self._run.finish()


class MetricsLogger:
    """Fan out one ``log()`` call to several backends (the Fabric
    ``loggers=[csv, wandb]`` pattern)."""

    def __init__(self, loggers: Iterable):
        self.loggers = list(loggers)

    def log(self, metrics: Dict[str, float], step: int):
        for lg in self.loggers:
            lg.log(metrics, step)

    def finalize(self):
        for lg in self.loggers:
            lg.finalize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()
        return False
