"""Metric aggregation and the CSV and TensorBoard sinks (stdlib only).

A copy of ``mm_s2ut/train/metrics.py`` (the reference's
``--tensorboard-logdir``): ``MetricsAggregator`` keeps running sums between
log flushes and normalises loss-like keys by ``ntokens``; ``MetricsWriter``
appends rows to ``{logdir}/metrics.csv`` and, with TensorBoard on, writes
the events file that ``tf.summary.create_file_writer`` +
``tf.summary.scalar`` write, without TensorFlow:

* TFRecords: the length (uint64), its masked CRC32C, the bytes, their
  masked CRC32C (CRC32C from a table: ``zlib.crc32`` is another
  polynomial);
* an ``Event`` with ``file_version: "brain.Event:2"`` first, then one per
  scalar: ``wall_time``, ``step`` and ``summary.value {tag:
  "{prefix}/{k}", metadata.plugin_data.plugin_name: "scalars", tensor:
  DT_FLOAT, shape [], the value's four bytes}``, each protobuf encoded by
  hand (varints and length-delimited fields);
* flushed after each ``write``.
"""
from __future__ import annotations

import csv
import math
import os
import socket
import struct
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: the CRC rotated right by 15 bits plus 0xA282EAD8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # int64 fields: a negative value takes ten bytes
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if not v:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str = "",
           summary: bytes = b"") -> bytes:
    """tensorflow.Event: wall_time 1 (double), step 2, file_version 3,
    summary 5, source_metadata 10 (the file's first event only)."""
    out = b"\x09" + struct.pack("<d", wall_time)
    if step:
        out += b"\x10" + _varint(step)
    if file_version:
        out += _field(3, file_version.encode())
        out += _field(10, _field(1, b"mm_s2ut_torch.train.metrics"))
    if summary:
        out += _field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    """Summary.Value: tag 1, tensor 8 (TensorProto: dtype 1 = DT_FLOAT, an
    empty tensor_shape 2, tensor_content 4), metadata 9 (plugin_data 1:
    plugin_name 1 "scalars")."""
    try:
        content = struct.pack("<f", value)
    except OverflowError:  # beyond float32: TensorFlow stores an infinity
        content = struct.pack("<f", math.copysign(math.inf, value))
    tensor = b"\x08\x01" + _field(2, b"") + _field(4, content)
    metadata = _field(1, _field(1, b"scalars"))
    return _field(1, tag.encode()) + _field(8, tensor) + _field(9, metadata)


class EventsFileWriter:
    """One ``events.out.tfevents.*`` file of scalar summaries in ``logdir``."""

    def __init__(self, logdir: str | Path):
        now = time.time()
        name = (f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}."
                f"{os.getpid()}.0.v2")
        self.path = Path(logdir) / name
        with open(self.path, "ab") as f:
            f.write(tfrecord(_event(float(int(now)), file_version="brain.Event:2")))

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        """One event per scalar, appended and flushed (the file is closed
        between writes, as ``metrics.csv`` is)."""
        with open(self.path, "ab") as f:
            for tag, v in values.items():
                summary = _field(1, _scalar_value(tag, float(v)))
                f.write(tfrecord(_event(time.time(), int(step), summary=summary)))


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
    """Rows of ``step`` and ``{prefix}/{metric}`` in ``metrics.csv``, and the
    same scalars in a TensorBoard events file unless
    ``enable_tensorboard`` is false."""

    def __init__(self, logdir: str | Path, enable_tensorboard: bool = True):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._csv_path = self.logdir / "metrics.csv"
        self._csv_fields = None
        self._tb = EventsFileWriter(self.logdir) if enable_tensorboard else None

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
        if self._tb is not None:
            self._tb.scalars(step, {f"{prefix}/{k}": v for k, v in metrics.items()})
