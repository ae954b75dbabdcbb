"""Per-stage pipeline timing accumulator.

Parity with the reference's hand-rolled profiler
(``model/StageMetrics.java:11-128``): the same 8 stages, per-stage
time/count/bytes accumulation, and a formatted text breakdown.  On the device
path, device stages additionally integrate with ``jax.profiler`` trace
annotations (see :mod:`datacomp.services.device_service`).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict


class Stage(Enum):
    FREQUENCY_ANALYSIS = "Frequency Analysis"
    HUFFMAN_TREE_BUILD = "Huffman Tree Build"
    ENCODING = "Encoding"
    CHECKSUM_COMPUTE = "Checksum Compute"
    FILE_IO = "File I/O"
    HEADER_WRITE = "Header Write"
    DECODING = "Decoding"
    CHECKSUM_VERIFY = "Checksum Verify"


@dataclass
class _StageAccum:
    total_ns: int = 0
    count: int = 0
    bytes_processed: int = 0


@dataclass
class StageMetrics:
    _stages: Dict[Stage, _StageAccum] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_stage(self, stage: Stage, duration_ns: int, bytes_processed: int = 0) -> None:
        with self._lock:
            acc = self._stages.setdefault(stage, _StageAccum())
            acc.total_ns += int(duration_ns)
            acc.count += 1
            acc.bytes_processed += int(bytes_processed)

    @contextmanager
    def timed(self, stage: Stage, nbytes: int = 0):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.record_stage(stage, time.perf_counter_ns() - t0, nbytes)

    def total_ns(self, stage: Stage) -> int:
        acc = self._stages.get(stage)
        return acc.total_ns if acc else 0

    def bytes_processed(self, stage: Stage) -> int:
        acc = self._stages.get(stage)
        return acc.bytes_processed if acc else 0

    def count(self, stage: Stage) -> int:
        acc = self._stages.get(stage)
        return acc.count if acc else 0

    def throughput_mbps(self, stage: Stage) -> float:
        acc = self._stages.get(stage)
        if not acc or acc.total_ns == 0:
            return 0.0
        return (acc.bytes_processed / 1e6) / (acc.total_ns / 1e9)

    def merge(self, other: "StageMetrics") -> None:
        with other._lock:
            items = list(other._stages.items())
        for stage, acc in items:
            self.record_stage(stage, acc.total_ns, acc.bytes_processed)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                s.name: {
                    "ms": acc.total_ns / 1e6,
                    "count": acc.count,
                    "bytes": acc.bytes_processed,
                    "mbps": self._mbps(acc),
                }
                for s, acc in self._stages.items()
            }

    @staticmethod
    def _mbps(acc: _StageAccum) -> float:
        if acc.total_ns == 0:
            return 0.0
        return (acc.bytes_processed / 1e6) / (acc.total_ns / 1e9)

    def summary(self) -> str:
        """Formatted per-stage breakdown (parity: ``StageMetrics.getSummary``)."""
        with self._lock:
            if not self._stages:
                return "No stage metrics recorded"
            total = sum(a.total_ns for a in self._stages.values())
            lines = ["Stage Performance Breakdown:", "=" * 64]
            for stage in Stage:
                acc = self._stages.get(stage)
                if acc is None:
                    continue
                pct = 100.0 * acc.total_ns / total if total else 0.0
                lines.append(
                    f"  {stage.value:<22} {acc.total_ns / 1e6:>10.2f} ms "
                    f"({pct:5.1f}%)  x{acc.count:<5} {self._mbps(acc):>9.1f} MB/s"
                )
            lines.append("=" * 64)
            lines.append(f"  {'Total':<22} {total / 1e6:>10.2f} ms")
            return "\n".join(lines)
