"""Headline benchmark: end-to-end compression throughput of the GPU service.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "MB/s", "vs_baseline": N,
   "device_platform": "...", "device_kind": "...", ...}

Baseline: the reference's measured end-to-end GPU-mode compression throughput
of 12.6 MB/s on its hardware of record (BASELINE.md:
`docs/SYSTEM_ARCHITECTURE.md:656`, `docs/CHAPTER5_IMPLEMENTATION_TESTING.md:1964`).

Measures the full service path (file I/O, SHA-256, histogram, codebook,
encode, container write) on a mixed file and verifies a byte-exact
decompress round trip.  The GPU service is the headline; the native CPU codec
runs beside it as a reference leg.  The GPU leg has no CPU fallback: no card,
a failed probe or a failed chunk exits non-zero.

Env: ``BENCH_SIZE_MB`` (128), ``BENCH_CHUNK_MB`` (16), ``BENCH_ITERS`` (2),
``BENCH_BACKENDS`` (``cpu,gpu``).
"""

import json
import os
import sys
import tempfile
import time

BASELINE_MBPS = 12.6  # reference GPU-mode end-to-end compression


def _time_service(svc, src, dcz, out, iters):
    svc.compress(src, dcz)  # warmup: compiles every executable it needs
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        svc.compress(src, dcz)
        times.append(time.perf_counter() - t0)
    svc.decompress(dcz, out)  # warmup of the decode executables
    dec_times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        svc.decompress(dcz, out)
        dec_times.append(time.perf_counter() - t0)
    file_size = os.path.getsize(src)
    with open(src, "rb") as a, open(out, "rb") as b:
        while True:
            ca, cb = a.read(1 << 20), b.read(1 << 20)
            if ca != cb:
                raise RuntimeError("round trip mismatch")
            if not ca:
                break
    return {
        "compress_mbps": round(file_size / 1e6 / min(times), 2),
        "decompress_mbps": round(file_size / 1e6 / min(dec_times), 2),
        "ratio": round(os.path.getsize(dcz) / file_size, 4),
    }


def main() -> int:
    size_mb = int(os.environ.get("BENCH_SIZE_MB", "128"))
    chunk_mb = int(os.environ.get("BENCH_CHUNK_MB", "16"))
    iters = int(os.environ.get("BENCH_ITERS", "2"))
    backends = os.environ.get("BENCH_BACKENDS", "cpu,gpu").split(",")

    from datacomp.config import load_config
    from datacomp.utils.card import card_line
    from datacomp.utils.testdata import write_mixed_file

    # format v2: gap arrays (parallel decode) + raw-store for incompressible
    # chunks; the framework's recommended format
    cfg = load_config(compression={"chunk_size_mb": chunk_mb, "format_version": 2})
    results = {}
    device = {"device_platform": "cpu", "device_kind": "cpu"}
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "bench.bin")
        write_mixed_file(src, size_mb)
        if "cpu" in backends:
            from datacomp.services.cpu_service import CpuCompressionService

            with CpuCompressionService(cfg) as svc:
                results["cpu"] = _time_service(
                    svc, src, os.path.join(d, "c.dcz"), os.path.join(d, "c.out"), iters
                )
        if "gpu" in backends:
            from datacomp.services.device_service import open_gpu_service

            with open_gpu_service(cfg) as svc:
                dev = svc._codec.freq._ensure_device()
                results["gpu"] = _time_service(
                    svc, src, os.path.join(d, "g.dcz"), os.path.join(d, "g.out"), iters
                )
            device = {
                "device_platform": dev.platform,
                "device_kind": dev.device_kind,
                "card": card_line(),
            }
    if not results:
        print(json.dumps({"error": "no backend requested", "backends": backends}))
        return 1
    head = "gpu" if "gpu" in results else "cpu"
    mbps = results[head]["compress_mbps"]
    print(json.dumps({
        "metric": "end_to_end_compress_throughput",
        "value": mbps,
        "unit": "MB/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 2),
        "backend": head,
        **device,
        "file_mb": size_mb,
        "iters": iters,
        **{f"{k}_{m}": v for k, r in results.items() for m, v in r.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
