"""Structured metrics logging: console + JSONL + snapshot CSV stream (port of
``pinns_tpu/train/metrics.py``, which it copies: it needs numpy only).

The JSONL records and the ``{"summary": ...}`` line have the JAX schema, and
the console lines keep the reference's ``It: ..., Loss: ...`` shape.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(
        self,
        out_dir: Optional[str] = None,
        name: str = "run",
        console: bool = True,
    ):
        self.out_dir = out_dir
        self.name = name
        self.console = console
        self._jsonl = None
        self._snapshot_path = None
        self._snapshot_header_written = False
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(
                os.path.join(out_dir, f"{name}_metrics.jsonl"), "a"
            )
            self._snapshot_path = os.path.join(out_dir, f"{name}_snapshots.csv")

    def log(self, **record):
        record.setdefault("time", time.time())
        if self.console:
            msg = (
                f"It: {record.get('epoch', 0)}, "
                f"Loss: {record.get('loss', 0):.3e}, "
                f"r(w) - z: {record.get('admm_misfit', 0):.3f}, "
                f"Time: {record.get('elapsed', 0):.2f} "
                f"[{record.get('phase', '')}]"
            )
            print(msg, flush=True)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def write_summary(self, summary: Dict):
        if self.console:
            for k, v in summary.items():
                if k.startswith("rel_l2"):
                    print(f"Error {k[7:]}: {v:e} ({v * 100:.4f} %)", flush=True)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"summary": summary}) + "\n")
            self._jsonl.flush()

    def append_snapshot(self, cols: Dict[str, np.ndarray]):
        """Append full-grid predictions keyed by epoch — the reference's
        convergence-history CSV format, consumed by the viz layer."""
        if self._snapshot_path is None:
            return
        keys = list(cols.keys())
        write_header = not self._snapshot_header_written and not (
            os.path.exists(self._snapshot_path)
            and os.path.getsize(self._snapshot_path) > 0
        )
        with open(self._snapshot_path, "a", newline="") as fh:
            writer = csv.writer(fh)
            if write_header:
                writer.writerow(keys)
            rows = np.column_stack([np.asarray(cols[k]).ravel() for k in keys])
            writer.writerows(rows.tolist())
        self._snapshot_header_written = True

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
