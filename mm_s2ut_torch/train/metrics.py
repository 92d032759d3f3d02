"""Metric aggregation and the CSV sink (stdlib only).

A copy of ``mm_s2ut/train/metrics.py`` without its TensorBoard writer:
``MetricsAggregator`` keeps running sums between log flushes and
normalises loss-like keys by ``ntokens``; ``MetricsWriter`` appends rows
to ``{logdir}/metrics.csv``.
"""
from __future__ import annotations

import csv
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional


class MetricsAggregator:
    """Running sums between log flushes (fairseq log_scalar analog)."""

    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._t0: Optional[float] = None  # first update() in the window

    def update(self, metrics: Dict[str, float]) -> None:
        if self._t0 is None:
            self._t0 = time.time()
        for k, v in metrics.items():
            self.sums[k] += float(v)
            self.counts[k] += 1

    def flush(self, normalize_by: Optional[str] = "ntokens") -> Dict[str, float]:
        """Normalized snapshot + reset. Loss-like keys divide by the
        normalizer sum; rate keys divide by elapsed wall time."""
        out: Dict[str, float] = {}
        denom = max(self.sums.get(normalize_by, 0.0), 1.0) if normalize_by else 1.0
        elapsed = max(time.time() - (self._t0 or time.time()), 1e-9)
        for k, v in self.sums.items():
            if k in ("ntokens", "nsentences"):
                out[k] = v
                out[f"{k}_per_sec"] = v / elapsed
            elif k == "grad_norm":
                out[k] = v / max(self.counts[k], 1)
            else:
                out[k] = v / denom
        self.sums.clear()
        self.counts.clear()
        self._t0 = None
        return out


class MetricsWriter:
    """Rows of ``step`` and ``{prefix}/{metric}`` in ``metrics.csv``."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.logdir / "metrics.csv"
        self._csv_fields = None

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "train") -> None:
        row = {"step": step, **{f"{prefix}/{k}": v for k, v in metrics.items()}}
        if self._csv_fields is None and self._csv_path.exists():
            # Resumed run: adopt the existing header so appended rows align.
            with open(self._csv_path, newline="") as f:
                first = f.readline().strip()
            self._csv_fields = first.split(",") if first else None
        if self._csv_fields is None:
            self._csv_fields = list(row)
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_fields).writeheader()
        new_fields = [k for k in row if k not in self._csv_fields]
        if new_fields:
            # First row of a new prefix (e.g. valid/*): extend the header
            # in place, padding the existing rows.
            self._csv_fields += new_fields
            with open(self._csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields)
                w.writeheader()
                w.writerows(rows)
        with open(self._csv_path, "a", newline="") as f:
            csv.DictWriter(f, fieldnames=self._csv_fields).writerow(row)
