"""CPU-vs-GPU benchmark suite.

Parity with ``benchmark/BenchmarkSuite.java:37-168``: config-driven warmup +
measurement iterations of ``compress`` (and here also ``decompress``) per
service, per-stage durations, and a comparison with speedup.  The reference
declared JSON/CSV output formats in config but never implemented them
(``application.conf:58-59``); they are implemented here.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config import AppConfig, load_config


@dataclass
class BenchmarkResult:
    service_name: str
    operation: str  # "compress" | "decompress"
    file_size: int
    iterations: int
    durations_s: List[float] = field(default_factory=list)
    compressed_size: int = 0
    stage_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def mean_s(self) -> float:
        return statistics.mean(self.durations_s) if self.durations_s else 0.0

    @property
    def best_s(self) -> float:
        return min(self.durations_s) if self.durations_s else 0.0

    @property
    def throughput_mbps(self) -> float:
        return self.file_size / 1e6 / self.mean_s if self.mean_s else 0.0

    @property
    def best_throughput_mbps(self) -> float:
        return self.file_size / 1e6 / self.best_s if self.best_s else 0.0

    @property
    def compression_ratio(self) -> float:
        return self.compressed_size / self.file_size if self.file_size else 0.0

    def as_dict(self) -> dict:
        return {
            "service": self.service_name,
            "operation": self.operation,
            "file_size": self.file_size,
            "iterations": self.iterations,
            "mean_s": self.mean_s,
            "best_s": self.best_s,
            "throughput_mbps": self.throughput_mbps,
            "best_throughput_mbps": self.best_throughput_mbps,
            "compression_ratio": self.compression_ratio,
            "stage_ms": self.stage_ms,
        }


class BenchmarkSuite:
    def __init__(self, config: Optional[AppConfig] = None):
        self.config = config or load_config()
        #: why the GPU leg did not run (None when it ran)
        self.device_error: Optional[str] = None

    def _services(self):
        from ..services.cpu_service import CpuCompressionService
        from ..services.device_service import open_gpu_service

        out = [("CPU", CpuCompressionService(self.config))]
        try:
            out.append(("GPU", open_gpu_service(self.config)))
            self.device_error = None
        except Exception as e:  # noqa: BLE001 — reported, never silent
            self.device_error = f"{type(e).__name__}: {e}"
        return out

    def benchmark_service(
        self, svc, name: str, input_path: str, workdir: str
    ) -> List[BenchmarkResult]:
        """One service's warmup+measure cycle.  With
        ``benchmark.detailed_profiling`` a ``jax.profiler`` trace of the
        measured iterations is written under ``<workdir>/jax-trace-<name>``
        (the TornadoVM-profiler-flag equivalent, ``docs/BENCHMARKING.md:91``
        in the reference)."""
        warmup = self.config.benchmark.warmup_iterations
        measure = self.config.benchmark.measurement_iterations
        file_size = os.path.getsize(input_path)
        dcz = os.path.join(workdir, f"bench_{name}.dcz")
        out = os.path.join(workdir, f"bench_{name}.out")

        comp = BenchmarkResult(name, "compress", file_size, measure)
        for _ in range(warmup):
            svc.compress(input_path, dcz)
        profiler_cm = None
        if self.config.benchmark.detailed_profiling:
            try:
                import jax

                profiler_cm = jax.profiler.trace(
                    os.path.join(workdir, f"jax-trace-{name}")
                )
                profiler_cm.__enter__()
            except Exception:  # noqa: BLE001 — profiling is best-effort
                profiler_cm = None
        for _ in range(measure):
            t0 = time.perf_counter()
            svc.compress(input_path, dcz)
            comp.durations_s.append(time.perf_counter() - t0)
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
        comp.compressed_size = os.path.getsize(dcz)
        comp.stage_ms = {
            k: v["ms"] for k, v in svc.get_last_stage_metrics().as_dict().items()
        }

        decomp = BenchmarkResult(name, "decompress", file_size, measure)
        for _ in range(warmup):
            svc.decompress(dcz, out)
        for _ in range(measure):
            t0 = time.perf_counter()
            svc.decompress(dcz, out)
            decomp.durations_s.append(time.perf_counter() - t0)
        decomp.compressed_size = comp.compressed_size
        decomp.stage_ms = {
            k: v["ms"] for k, v in svc.get_last_stage_metrics().as_dict().items()
        }
        for p in (dcz, out):
            if os.path.exists(p):
                os.remove(p)
        return [comp, decomp]

    def run_full_suite(
        self, input_path: Optional[str] = None, size_mb: int = 16,
        output_format: str = "console",
    ) -> List[BenchmarkResult]:
        results: List[BenchmarkResult] = []
        with tempfile.TemporaryDirectory() as workdir:
            if input_path is None:
                from ..utils.testdata import generate_compressible_file

                input_path = os.path.join(workdir, "bench_input.bin")
                generate_compressible_file(size_mb, input_path)
            services = self._services()
            try:
                for name, svc in services:
                    results.extend(
                        self.benchmark_service(svc, name, input_path, workdir)
                    )
            finally:
                for _, svc in services:
                    svc.close()
        return results

    @staticmethod
    def speedup(results: List[BenchmarkResult], operation: str = "compress") -> Optional[float]:
        """GPU-over-CPU speedup (parity: ``BenchmarkComparison.getSpeedup``)."""
        by = {r.service_name: r for r in results if r.operation == operation}
        if "CPU" in by and "GPU" in by and by["GPU"].mean_s > 0:
            return by["CPU"].mean_s / by["GPU"].mean_s
        return None

    def format_results(self, results: List[BenchmarkResult], fmt: str = "console") -> str:
        if fmt == "json":
            return json.dumps(
                {
                    "results": [r.as_dict() for r in results],
                    "speedup_compress": self.speedup(results, "compress"),
                    "speedup_decompress": self.speedup(results, "decompress"),
                    "device_error": self.device_error,
                },
                indent=2,
            )
        if fmt == "csv":
            lines = ["service,operation,file_size,mean_s,best_s,throughput_mbps,ratio"]
            for r in results:
                lines.append(
                    f"{r.service_name},{r.operation},{r.file_size},"
                    f"{r.mean_s:.6f},{r.best_s:.6f},{r.throughput_mbps:.2f},"
                    f"{r.compression_ratio:.4f}"
                )
            return "\n".join(lines)
        lines = ["", "Benchmark Results", "=" * 68]
        for r in results:
            lines.append(
                f"  {r.service_name:<4} {r.operation:<10} "
                f"{r.file_size / 1e6:8.1f} MB  mean {r.mean_s * 1e3:9.1f} ms  "
                f"{r.throughput_mbps:9.1f} MB/s  ratio {r.compression_ratio * 100:6.2f}%"
            )
        if self.device_error is not None:
            lines.append(f"  GPU  not run: {self.device_error}")
        for op in ("compress", "decompress"):
            s = self.speedup(results, op)
            if s is not None:
                lines.append(f"  GPU speedup ({op}): {s:.2f}x")
        lines.append("=" * 68)
        return "\n".join(lines)
