"""Command-line interface.

Parity surface: ``cli/DataCompCLI.java:24-43`` — ``compress|c`` /
``decompress|d <input> <output> [chunkMB]`` with progress %, final
size/ratio/time/MB/s report — extended with ``verify``, ``resume``, ``bench``
and ``gen`` subcommands and backend selection (the reference CLI is CPU-only;
here ``--backend gpu`` engages the device pipeline on the GPU, with no CPU
fallback).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .config import load_config
from .models import MetricsService


def _progress_printer(label: str, total_bytes: int = 0):
    """Progress line with live throughput and ETA (parity with the
    reference's compress view, ``ui/CompressController.java:257-269``)."""
    state = {"last": -1, "t0": None}

    def cb(frac: float) -> None:
        now = time.perf_counter()
        if state["t0"] is None:
            state["t0"] = now
        pct = int(frac * 100)
        if pct == state["last"]:
            return
        state["last"] = pct
        line = f"\r{label}: {pct:3d}%"
        elapsed = now - state["t0"]
        if total_bytes and frac > 0 and elapsed > 0.05:
            done = frac * total_bytes
            mbps = done / 1e6 / elapsed
            remaining = elapsed * (1 - frac) / frac
            eta = f"{int(remaining) // 60}:{int(remaining) % 60:02d}"
            line += f"  {mbps:7.1f} MB/s  ETA {eta} "
        print(line, end="", flush=True)

    return cb


def _input_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


def _make_service(args):
    comp = {
        "chunk_size_mb": args.chunk_mb,
        "format_version": getattr(args, "format", 1),
        "max_code_len": getattr(args, "max_code_len", 0),
    }
    if getattr(args, "codebook_mode", None):
        comp["codebook_mode"] = args.codebook_mode
    cfg = load_config(compression=comp)
    if args.backend == "cpu":
        from .services.cpu_service import CpuCompressionService

        return CpuCompressionService(cfg)
    if args.backend == "gpu":
        from .services.device_service import open_gpu_service

        return open_gpu_service(cfg)
    from .services.factory import create_compression_service

    return create_compression_service(cfg)


def _report(op: str, in_path: str, out_path: str, seconds: float) -> None:
    in_size = os.path.getsize(in_path)
    out_size = os.path.getsize(out_path)
    # compression throughput over input bytes; decompression over output
    # bytes (reference parity: DataCompCLI.java:114-119)
    mbps = max(in_size if op == "Compression" else out_size, 0) / 1e6 / max(seconds, 1e-9)
    print(f"\n{op} complete:")
    print(f"  Input:      {in_size:,} bytes")
    print(f"  Output:     {out_size:,} bytes")
    if op == "Compression" and in_size > 0:
        print(f"  Ratio:      {out_size / in_size * 100:.2f}%")
        print(f"  Space saved: {(1 - out_size / in_size) * 100:.2f}%")
    print(f"  Time:       {seconds:.2f} s")
    print(f"  Throughput: {mbps:.2f} MB/s")


def cmd_compress(args) -> int:
    if getattr(args, "sharded", False):
        return _cmd_compress_sharded(args)
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.compress(args.input, args.output, _progress_printer("Compressing", _input_size(args.input)))
        _report("Compression", args.input, args.output, time.perf_counter() - t0)
        cfg = load_config()
        if cfg.output.verify_after_compress and not args.no_verify:
            ok = svc.verify_integrity(args.output)
            print(f"  Verify:     {'OK' if ok else 'FAILED'}")
            if not ok:
                return 1
        if args.stages:
            print(svc.get_last_stage_metrics().summary())
        return 0
    finally:
        svc.close()


def _sharded_setup(args, cfg):
    """Codec backend, config and mesh for ``--sharded``.  ``--backend gpu``
    shards over the local GPUs (none is an error, never a CPU run);
    ``auto`` over every local device of JAX's default backend; ``cpu`` runs
    the native host codec with no mesh."""
    if args.backend == "cpu":
        return "cpu", cfg, None
    import jax

    from .parallel import make_mesh
    from .services.device_service import gpu_config

    if args.backend == "gpu":
        cfg = gpu_config(cfg)
        try:
            devs = jax.local_devices(backend="gpu")
        except RuntimeError as e:
            raise RuntimeError(f"no gpu device available: {e}") from e
    else:
        devs = jax.local_devices()
    if len(devs) == 1:
        print(f"note: one local {devs[0].platform} device — sharded mode "
              "degrades to the batched single-device path")
        return "gpu", cfg, None
    return "gpu", cfg, make_mesh(devices=devs)


def _cmd_compress_sharded(args) -> int:
    """Multi-device compress: the stripe shards over a mesh of the local
    devices (the axis the reference never had; multi-process clusters use
    ``parallel.multihost`` directly with ``jax.distributed``)."""
    from .parallel.multihost import compress_multihost

    cfg = load_config(
        compression={
            "chunk_size_mb": args.chunk_mb, "format_version": 2,
            "codebook_mode": "device",
            "max_code_len": getattr(args, "max_code_len", 0),
        }
    )
    backend, cfg, mesh = _sharded_setup(args, cfg)
    t0 = time.perf_counter()
    compress_multihost(
        args.input, args.output, cfg, backend=backend, mesh=mesh,
        progress=_progress_printer("Compressing", _input_size(args.input)),
    )
    _report("Compression", args.input, args.output, time.perf_counter() - t0)
    if not args.no_verify:
        from .services.cpu_service import CpuCompressionService

        with CpuCompressionService(cfg) as svc:
            ok = svc.verify_integrity(args.output)
        print(f"  Verify:     {'OK' if ok else 'FAILED'}")
        if not ok:
            return 1
    return 0


def _cmd_decompress_sharded(args) -> int:
    """Multi-device decompress: the stripe shards over a mesh of the local
    devices (symmetric to --sharded compress; multi-process clusters use
    ``parallel.multihost.decompress_multihost`` with ``jax.distributed``)."""
    from .parallel.multihost import decompress_multihost

    backend, cfg, mesh = _sharded_setup(
        args, load_config(compression={"chunk_size_mb": args.chunk_mb})
    )
    t0 = time.perf_counter()
    decompress_multihost(
        args.input, args.output, cfg, backend=backend, mesh=mesh,
        progress=_progress_printer("Decompressing", _input_size(args.input)),
    )
    _report("Decompression", args.input, args.output, time.perf_counter() - t0)
    return 0


def cmd_decompress(args) -> int:
    if getattr(args, "sharded", False):
        return _cmd_decompress_sharded(args)
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.decompress(args.input, args.output, _progress_printer("Decompressing", _input_size(args.input)))
        _report("Decompression", args.input, args.output, time.perf_counter() - t0)
        if args.stages:
            print(svc.get_last_stage_metrics().summary())
        return 0
    finally:
        svc.close()


def cmd_verify(args) -> int:
    svc = _make_service(args)
    try:
        ok = svc.verify_integrity(args.input, deep=args.deep)
        print(f"{args.input}: {'OK' if ok else 'CORRUPT'}")
        return 0 if ok else 1
    finally:
        svc.close()


def cmd_resume(args) -> int:
    svc = _make_service(args)
    try:
        t0 = time.perf_counter()
        svc.resume_compression(
            args.input, args.output, args.last_chunk,
            _progress_printer("Resuming", _input_size(args.input))
        )
        _report("Compression", args.input, args.output, time.perf_counter() - t0)
        return 0
    finally:
        svc.close()


def cmd_bench(args) -> int:
    if getattr(args, "batched", False):
        from .benchmark.kernels import (
            format_pipeline_batch_results,
            run_decode_batch_bench,
            run_pipeline_batch_bench,
        )

        results = run_pipeline_batch_bench(size_mb=args.size_mb, kind=args.kind)
        results.update(run_decode_batch_bench(size_mb=args.size_mb, kind=args.kind))
        if args.format_out == "json":
            import json as _json

            print(_json.dumps({"chunk_mb": args.size_mb, "pipeline": results}, indent=2))
        elif args.format_out == "csv":
            print("name,batch,compute_ms_per_chunk,mbps_per_chunk,"
                  "overhead_ms_per_program,overhead_ms_per_chunk")
            for name, r in results.items():
                print(f"{name},{r['batch']},{r['compute_ms_per_chunk']},"
                      f"{r['mbps_per_chunk']},{r['overhead_ms_per_program']},"
                      f"{r['overhead_ms_per_chunk']}")
        else:
            print(format_pipeline_batch_results(results, args.size_mb))
        return 0
    if getattr(args, "kernels", False):
        from .benchmark.kernels import format_kernel_results, run_kernel_bench

        results = run_kernel_bench(size_mb=args.size_mb, kind=args.kind)
        print(format_kernel_results(results, args.size_mb, args.format_out))
        return 0
    if getattr(args, "corpus", None):
        from .benchmark.corpus import format_corpus_results, run_corpus_bench

        report = run_corpus_bench(args.corpus, backend=args.corpus_backend)
        print(format_corpus_results(report, args.format_out))
        return 0
    from .benchmark.suite import BenchmarkSuite

    suite = BenchmarkSuite(load_config())
    results = suite.run_full_suite(
        input_path=args.input, size_mb=args.size_mb, output_format=args.format_out
    )
    print(suite.format_results(results, args.format_out))
    return 0


def cmd_gen(args) -> int:
    from .utils.testdata import (
        generate_compressible_file,
        generate_corpus,
        generate_random_file,
    )

    if getattr(args, "corpus", False):
        written = generate_corpus(args.output, scale=args.size_mb / 64.0)
        for path, kind in written:
            print(f"  {path}  [{kind}]")
        print(f"Generated {len(written)}-file corpus in {os.path.abspath(args.output)}")
        return 0
    if args.compressible:
        generate_compressible_file(args.size_mb, args.output)
    else:
        generate_random_file(args.size_mb, args.output)
    print(f"Generated: {os.path.abspath(args.output)}")
    return 0


def cmd_ui(args) -> int:
    """Interactive terminal app: the reference's 4-view windowed application
    (Dashboard/Compress/Benchmark/Settings) as a curses TUI."""
    from .ui.app import run_app

    return run_app()


def cmd_dashboard(args) -> int:
    from .ui import export_html, render_dashboard

    print(render_dashboard())
    if args.html:
        export_html(args.html, theme=args.theme)
        print(f"HTML report written to {args.html}")
    return 0


def cmd_devices(args) -> int:
    from .services.device_service import get_available_devices

    for line in get_available_devices():
        print(line)
    return 0


TEMPLATE_TOML = """\
# datacomp configuration (all keys optional; defaults shown)
[datacomp.compression]
chunk-size-mb = 16
io-buffer-size-kb = 256
cpu-threads = 0            # 0 = auto (clamp(cores, 2, 8))
use-memory-mapped-io = true
subblock-symbols = 4032    # v2 gap-array granularity (divisible by 32 and by 2-4)
format-version = 1         # 1 = reference-bit-compatible, 2 = +gap arrays
codebook-mode = "java"     # java | fast | device
max-code-len = 0           # 0 = unlimited (v1) / auto (v2); "auto" = shallowest
                           # cap costing <0.5% bits; N caps at N bits; 32 = opt out

[datacomp.device]
auto-detect = true
force-cpu = false
platform = "any"           # gpu | cpu | any
device-index = -1
fallback-on-error = true
parallel-chunks = 3

[datacomp.benchmark]
warmup-iterations = 3
measurement-iterations = 5
detailed-profiling = false
output-format = "console"  # console | json | csv

[datacomp.logging]
level = "INFO"
metrics-enabled = true
file-path = ""

[datacomp.output]
compressed-extension = ".dcz"
verify-after-compress = true
keep-original = true
"""


def cmd_config(args) -> int:
    """Settings surface (replaces the reference's JavaFX Settings view)."""
    if args.init:
        path = args.init
        if os.path.exists(path) and not args.force:
            print(f"error: {path} exists (use --force to overwrite)", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(TEMPLATE_TOML)
        print(f"Wrote config template to {path}")
        return 0
    import dataclasses

    cfg = load_config(args.file)
    for section in ("compression", "device", "benchmark", "logging", "output"):
        print(f"[{section}]")
        for fld in dataclasses.fields(getattr(cfg, section)):
            print(f"  {fld.name} = {getattr(getattr(cfg, section), fld.name)!r}")
    return 0


def cmd_stats(args) -> int:
    ms = MetricsService.get_instance()
    recent = ms.get_recent()
    if not recent:
        print("No operations recorded in this session")
        return 0
    for m in recent:
        print(
            f"{m.file_name}: {m.operation.value} {m.original_size:,} B "
            f"@ {m.throughput_mbps:.1f} MB/s [{m.backend}]"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcz",
        description="datacomp: chunked canonical-Huffman compression on the GPU",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, output=True):
        sp.add_argument("input")
        if output:
            sp.add_argument("output")
        sp.add_argument("chunk_mb", nargs="?", type=int, default=16,
                        help="chunk size in MB (default 16)")
        sp.add_argument("--backend", choices=["auto", "cpu", "gpu"], default="auto")
        sp.add_argument("--stages", action="store_true", help="print per-stage timing")

    sp = sub.add_parser("compress", aliases=["c"], help="compress a file")
    common(sp)
    sp.add_argument("--format", type=int, choices=[1, 2], default=1,
                    help="container version: 1=reference-compatible, 2=+gap arrays (device decode)")
    sp.add_argument("--no-verify", action="store_true",
                    help="skip the post-compress integrity verification")
    sp.add_argument("--max-code-len", default=0, metavar="N|auto",
                    type=lambda s: -1 if s.strip().lower() == "auto" else int(s),
                    help="cap code lengths at N bits via optimal package-merge "
                         "(0 = unlimited [v1 default]; 'auto' = shallowest cap "
                         "costing <0.5%% extra bits [v2 default]; <=16 keeps "
                         "v2 decode on-device)")
    sp.add_argument("--sharded", action="store_true",
                    help="shard chunk groups over ALL local devices via one "
                         "sharded device program per group "
                         "(compress_multihost over a local mesh; implies "
                         "--format 2, --codebook-mode device; --backend gpu "
                         "requires GPUs, cpu runs the host codec)")
    sp.add_argument("--codebook-mode", choices=["java", "fast", "device"],
                    default=None,
                    help="java = reference-bit-exact tie-breaks (default), "
                         "fast = two-queue optimal, device = fused on-device build")
    sp.set_defaults(func=cmd_compress)

    sp = sub.add_parser("decompress", aliases=["d"], help="decompress a .dcz file")
    common(sp)
    sp.add_argument("--sharded", action="store_true",
                    help="shard chunk groups over ALL local devices via one "
                         "sharded device program per group "
                         "(decompress_multihost over a local mesh; --backend "
                         "gpu requires GPUs, cpu runs the host codec; "
                         "v1/deep-codebook chunks route to the host decoder)")
    sp.set_defaults(func=cmd_decompress)

    sp = sub.add_parser("verify", help="verify container integrity")
    common(sp, output=False)
    sp.add_argument("--deep", action="store_true", help="full decode + checksum check")
    sp.set_defaults(func=cmd_verify)

    sp = sub.add_parser("resume", help="resume an interrupted compression")
    common(sp)
    sp.add_argument("--last-chunk", type=int, required=True,
                    help="highest chunk index known completed (-1 restarts)")
    sp.set_defaults(func=cmd_resume)

    sp = sub.add_parser("bench", help="run the CPU-vs-GPU benchmark suite")
    sp.add_argument("--input", default=None, help="benchmark input file (default: generated)")
    sp.add_argument("--size-mb", type=int, default=16)
    sp.add_argument("--format-out", choices=["console", "json", "csv"], default="console")
    sp.add_argument("--kernels", action="store_true",
                    help="slope-time the device kernels instead of the services")
    sp.add_argument("--batched", action="store_true",
                    help="device-side A/B of the batched chunk pipeline "
                         "(B=1/4/8 chunks per program)")
    sp.add_argument("--kind", default="text",
                    choices=["text", "compressible", "skewed", "random"],
                    help="data kind for --kernels (default text)")
    sp.add_argument("--corpus", default=None, metavar="DIR",
                    help="benchmark every file in DIR: per-file ratio vs the "
                         "reference's published per-type table + entropy bound")
    sp.add_argument("--corpus-backend", choices=["cpu", "gpu"], default="cpu")
    sp.set_defaults(func=cmd_bench)

    sp = sub.add_parser("gen", help="generate deterministic test data")
    sp.add_argument("size_mb", type=int)
    sp.add_argument("output")
    sp.add_argument("--compressible", action="store_true")
    sp.add_argument("--corpus", action="store_true",
                    help="treat OUTPUT as a directory; write the Silesia-style "
                         "mixed corpus scaled to SIZE_MB total")
    sp.set_defaults(func=cmd_gen)

    sp = sub.add_parser("stats", help="show session metrics")
    sp.set_defaults(func=cmd_stats)

    sp = sub.add_parser("ui", help="interactive terminal app (4 views: "
                                   "dashboard/compress/benchmark/settings)")
    sp.set_defaults(func=cmd_ui)

    sp = sub.add_parser("dashboard", help="system/device info + metrics dashboard")
    sp.add_argument("--html", default=None, help="also write an HTML report here")
    sp.add_argument("--theme", choices=["dark", "light", "auto"], default="dark",
                    help="HTML report theme (auto follows prefers-color-scheme)")
    sp.set_defaults(func=cmd_dashboard)

    sp = sub.add_parser("devices", help="enumerate compute devices")
    sp.set_defaults(func=cmd_devices)

    sp = sub.add_parser("config", help="show effective configuration / write a template")
    sp.add_argument("--file", default=None, help="config file to load")
    sp.add_argument("--init", default=None, metavar="PATH",
                    help="write a commented datacomp.toml template to PATH")
    sp.add_argument("--force", action="store_true")
    sp.set_defaults(func=cmd_config)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.logging_setup import setup_logging

    setup_logging()
    try:
        return args.func(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
