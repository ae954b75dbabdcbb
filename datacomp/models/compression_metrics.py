"""Per-operation metrics record (parity: ``model/CompressionMetrics.java``)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum


class OperationType(Enum):
    COMPRESSION = "Compression"
    DECOMPRESSION = "Decompression"


@dataclass(frozen=True)
class CompressionMetrics:
    file_name: str
    operation: OperationType
    original_size: int
    processed_size: int  # compressed size for compression, output size for decompression
    duration_s: float
    backend: str  # "CPU" | "GPU" (the platform the device service ran on)
    timestamp: float = field(default_factory=time.time)

    @property
    def throughput_mbps(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return self.original_size / 1e6 / self.duration_s

    @property
    def compression_ratio(self) -> float:
        """compressed/original, as a fraction (reference reports percent)."""
        if self.operation is not OperationType.COMPRESSION or self.original_size == 0:
            return 1.0
        return self.processed_size / self.original_size

    @property
    def space_saved_percent(self) -> float:
        return (1.0 - self.compression_ratio) * 100.0

    def as_dict(self) -> dict:
        return {
            "file": self.file_name,
            "operation": self.operation.value,
            "original_size": self.original_size,
            "processed_size": self.processed_size,
            "duration_s": self.duration_s,
            "backend": self.backend,
            "throughput_mbps": self.throughput_mbps,
            "compression_ratio": self.compression_ratio,
            "space_saved_percent": self.space_saved_percent,
            "timestamp": self.timestamp,
        }
