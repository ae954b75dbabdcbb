"""Chip smoke run: drive the device codec once, through the entry points a
user calls, at the widths users run, on one GPU — and check every result
bit-exactly against the host codec.

    python chip_smoke.py                 # phases device, ops, service, cli
    python chip_smoke.py --phase ops     # one phase (the gpu test tier)
    python chip_smoke.py --cards 4       # only the four-GPU sharded phase

Phases:

* ``device``  — JAX sees a GPU and the service picks it;
* ``ops``     — every device op on one 16 MB padded chunk of text,
  compressible and skewed data (plus a ragged ``valid_len``), compiled for
  the card and compared with the host oracle at tolerance 0; prints cold and
  warm compile seconds and ``memory_analysis()`` of each executable;
* ``service`` — a 128 MB mixed file through the GPU service in four
  configurations: compress → deep verify → decompress → byte-equal, v1/java
  byte-identical to the CPU service, and every device-decodable v2 chunk
  decoded on the device;
* ``cli``     — ``dcz compress --backend gpu --format 2``, ``verify --deep``,
  ``decompress``, in-process;
* ``cards``   — (``--cards 4`` only) ``compress_multihost`` /
  ``decompress_multihost`` and ``dcz --sharded`` over a 4-GPU mesh on a
  256 MB file, byte-identical to the one-card service.

Everything runs in this one process (a second JAX process could not reserve
the card).  Any failure raises; the exit code is then non-zero and no result
line is printed.  On success the last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

CHUNK_MB = 16
SERVICE_FILE_MB = 128
CARDS_FILE_MB = 256
RAGGED_TAIL = 12345


def log(msg: str) -> None:
    print(msg, flush=True)


def _mb(nbytes) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


def file_sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while blk := f.read(1 << 24):
            h.update(blk)
    return h.hexdigest()


def steady_ms(fn, *args, reps: int = 10) -> float:
    """Median wall time of ``fn(*args)`` on device-resident arguments, each
    call ended by ``block_until_ready``: one program's device time plus its
    dispatch (smoke timing, not a benchmark)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def assert_same_file(a: str, b: str, what: str) -> None:
    if os.path.getsize(a) != os.path.getsize(b) or file_sha(a) != file_sha(b):
        raise AssertionError(f"{what}: {a} and {b} differ")


# -- phase: device ------------------------------------------------------------


def phase_device(platform: str = "gpu"):
    import jax

    from datacomp import native
    from datacomp.services.device_service import pick_device

    devs = jax.devices()
    log(f"jax {jax.__version__}; devices: {[d.device_kind for d in devs]}")
    if devs[0].platform != platform:
        raise AssertionError(f"JAX's devices are {devs[0].platform}, not {platform}")
    dev = pick_device(platform)
    if dev != devs[0]:
        raise AssertionError(f"pick_device({platform!r}) returned {dev}, not {devs[0]}")
    if not native.is_available():
        raise AssertionError(f"native host codec did not build: {native.build_error()}")
    log(f"device: {dev.platform} {dev.device_kind} id={dev.id}; native host codec built")
    return dev


# -- phase: ops ---------------------------------------------------------------


class Compiler:
    """Compiles each executable ahead of time, prints its cold compile time
    and ``memory_analysis()``, and re-times every compile after
    ``jax.clear_caches()`` (the warm figure: a persistent-cache hit when the
    cold compile was slow enough to be cached)."""

    def __init__(self):
        self.jobs = []

    def compile(self, name, jitted, *args):
        t0 = time.perf_counter()
        exe = jitted.lower(*args).compile()
        cold = time.perf_counter() - t0
        ma = exe.memory_analysis()
        mem = (
            f"args {_mb(ma.argument_size_in_bytes)}, out {_mb(ma.output_size_in_bytes)}, "
            f"temp {_mb(ma.temp_size_in_bytes)}, code {_mb(ma.generated_code_size_in_bytes)}"
            if ma is not None else "not reported"
        )
        log(f"compile {name}: cold {cold:.2f} s; memory_analysis: {mem}")
        self.jobs.append((name, jitted, args))
        return exe

    def rewarm(self):
        import jax

        jax.clear_caches()
        for name, jitted, args in self.jobs:
            t0 = time.perf_counter()
            jitted.lower(*args).compile()
            log(f"compile {name}: warm {time.perf_counter() - t0:.2f} s")


def phase_ops(chunk_bytes: int = CHUNK_MB << 20, subblock: int = 4032):
    import jax
    import jax.numpy as jnp

    from datacomp import native
    from datacomp.core.huffman import (
        build_code_lengths,
        build_codebook,
        canonical_codes_from_lengths,
    )
    from datacomp.ops import (
        DEFAULT_REFILL_WORDS,
        build_decode_tables,
        cmp_len_bucket,
        decode_device,
        device_canonical_codes,
        device_codebook,
        encode_device_merge,
        encode_device_merge_slotted,
        histogram_device,
        max_code_len,
        payload_to_words,
        slot_bucket,
        syms_per_refill,
        words_to_bytes,
    )
    from datacomp.utils.testdata import generate_bytes

    comp = Compiler()
    out_words = (9 * chunk_bytes + 31) // 32 + 2
    nsub = (chunk_bytes + subblock - 1) // subblock
    wcap = (9 * chunk_bytes + 31) // 32 + 4  # the service's decode word cap
    dev = jax.devices()[0]
    execs = {}

    def exe(name, jitted, *args):
        if name not in execs:
            execs[name] = comp.compile(name, jitted, *args)
        return execs[name]

    def check_encode(tag, words, tb, gaps, data, lengths, codes):
        ref_payload, ref_gaps = native.encode(data, lengths, codes, subblock=subblock)
        tb = int(tb)
        payload = words_to_bytes(np.asarray(words)[: (tb + 31) // 32], tb)
        if payload != bytes(ref_payload):
            raise AssertionError(f"{tag}: payload differs from native.encode")
        g = np.asarray(gaps)[: ref_gaps.size]
        if not np.array_equal(g, ref_gaps):
            raise AssertionError(f"{tag}: gap array differs from native.encode")

    def check_decode(tag, data, lengths, codes):
        ml = max_code_len(lengths)
        payload, gaps = native.encode(data, lengths, codes, subblock=subblock)
        words = payload_to_words(bytes(payload))
        wpad = np.zeros(wcap, np.uint32)
        wpad[: words.size] = words
        gpad = np.zeros(nsub, np.uint32)
        gpad[: gaps.size] = gaps
        lim, adj, sym = build_decode_tables(lengths)
        sps = syms_per_refill(ml, subblock, DEFAULT_REFILL_WORDS)
        cmp = cmp_len_bucket(ml)
        args = jax.device_put((wpad, gpad, lim, adj, sym), dev)
        fn = exe(
            f"decode_device[sps={sps},cmp={cmp}]",
            jax.jit(lambda w, g, l, a, s: decode_device(
                w, g, l, a, s, subblock, nsub, syms_per_step=sps, cmp_len=cmp,
                refill_words=DEFAULT_REFILL_WORDS,
            )),
            *args,
        )
        out = np.asarray(fn(*args))
        if not np.array_equal(out[: data.size], data):
            raise AssertionError(f"{tag}: device decode differs from the input")
        log(f"  {tag}: decode ok ({ml}-bit codes, {sps} syms/refill, "
            f"{steady_ms(fn, *args):.2f} ms steady)")

    cases = [
        ("text", chunk_bytes),
        ("compressible", chunk_bytes),
        ("skewed", chunk_bytes),
        ("text", chunk_bytes - RAGGED_TAIL),
    ]
    for kind, n in cases:
        tag = f"{kind}[valid={n}]"
        padded = np.zeros(chunk_bytes, np.uint8)
        padded[:n] = np.frombuffer(generate_bytes(kind, n), np.uint8)
        data = padded[:n]
        x, v = jax.device_put(padded, dev), jnp.int32(n)

        hist_exe = exe("histogram_device", histogram_device, x, v)
        hist = np.asarray(hist_exe(x, v))
        ref_hist = np.bincount(data, minlength=256)
        if not np.array_equal(hist, ref_hist):
            raise AssertionError(f"{tag}: histogram_device differs from np.bincount")
        log(f"  {tag}: histogram ok ({steady_ms(hist_exe, x, v):.3f} ms steady)")

        hd = jax.device_put(hist.astype(np.int32), dev)
        dl, dc = exe("device_codebook", device_codebook, hd)(hd)
        dl = np.asarray(dl).astype(np.int32)
        dc = np.asarray(dc).astype(np.uint32)
        host_bits = int(ref_hist @ build_code_lengths(ref_hist, mode="fast"))
        if int(ref_hist @ dl) != host_bits:
            raise AssertionError(f"{tag}: device codebook is not optimal")
        dcc = np.asarray(
            exe("device_canonical_codes", device_canonical_codes, jnp.asarray(dl))(
                jnp.asarray(dl)
            )
        ).astype(np.uint32)
        if not (np.array_equal(dcc, canonical_codes_from_lengths(dl))
                and np.array_equal(dc, dcc)):
            raise AssertionError(f"{tag}: device canonical codes differ from host")
        log(f"  {tag}: codebook ok ({max_code_len(dl)}-bit, {host_bits} bits)")

        slots = slot_bucket(max_code_len(dl))
        ld, cd = jax.device_put((dl, dc), dev)
        enc = exe(
            f"encode_device_merge[max_slots={slots}]",
            jax.jit(lambda d, v, l, c, s=slots: encode_device_merge(
                d, v, l, c, out_words, subblock, max_slots=s)),
            x, v, ld, cd,
        )
        w, tb, g = enc(x, v, ld, cd)
        check_encode(f"{tag} encode[max_slots={slots}]", w, tb, g, data, dl, dc)
        enc_s = exe(
            "encode_device_merge_slotted",
            jax.jit(lambda d, v, l, c: encode_device_merge_slotted(
                d, v, l, c, out_words, subblock)),
            x, v, ld, cd,
        )
        w, tb, g = enc_s(x, v, ld, cd)
        check_encode(f"{tag} encode_slotted", w, tb, g, data, dl, dc)
        log(f"  {tag}: encode ok, static and slotted ("
            f"{steady_ms(enc, x, v, ld, cd):.2f} ms static, "
            f"{steady_ms(enc_s, x, v, ld, cd):.2f} ms slotted, steady)")

        if max_code_len(dl) <= 16:
            check_decode(f"{tag} natural", data, dl, dc)
        else:
            log(f"  {tag}: natural codebook is {max_code_len(dl)}-bit, "
                "decoded on the host by the service (no device decode)")
        l8, c8 = build_codebook(ref_hist.astype(np.int64), mode="fast", max_len=8)
        check_decode(f"{tag} cap8", data, l8, c8)
    comp.rewarm()


# -- phase: service -----------------------------------------------------------


def _service_config(version: int, mode: str, batch: int, chunk_mb: int, platform: str):
    from dataclasses import replace

    from datacomp.config import load_config

    cfg = load_config(
        compression={
            "chunk_size_mb": chunk_mb, "format_version": version,
            "codebook_mode": mode,
        },
        device={"batch_chunks": batch},
    )
    return replace(
        cfg, device=replace(cfg.device, platform=platform, fallback_on_error=False)
    )


def _count_routes(svc, dcz: str):
    """(device, host, raw) decode routes of a container's chunks, and the
    chunks with codes ≤ 16 bits that the service would NOT decode on the
    device (must be none)."""
    from datacomp.core import container as ct
    from datacomp.ops import TABLE_BITS, max_code_len

    header, start = ct.read_container(dcz)
    codec = svc._codec
    routes = {"device": 0, "host": 0, "raw": 0}
    missed = []
    with open(dcz, "rb") as f:
        for m in header.chunks:
            f.seek(start + m.compressed_offset)
            payload = f.read(m.compressed_size)
            if codec._is_raw_store(payload, m, header):
                routes["raw"] += 1
            elif codec._device_decode_plan(payload, m, header) is not None:
                routes["device"] += 1
            else:
                routes["host"] += 1
                if (header.version >= 2
                        and max_code_len(m.code_lengths) <= TABLE_BITS):
                    missed.append(m.index)
    return routes, missed


def phase_service(file_mb: int = SERVICE_FILE_MB, chunk_mb: int = CHUNK_MB,
                  platform: str = "gpu", workdir: str = "."):
    from datacomp.services.cpu_service import CpuCompressionService
    from datacomp.services.device_service import DeviceCompressionService
    from datacomp.utils.testdata import write_mixed_file

    src = os.path.join(workdir, "mixed.bin")
    write_mixed_file(src, file_mb)
    size = os.path.getsize(src)
    log(f"service input: {size} bytes mixed (text, compressible, skewed, random)")
    for version, mode, batch in ((2, "device", 1), (2, "device", 4),
                                 (2, "fast", 0), (1, "java", 0)):
        tag = f"v{version}/{mode}/batch={batch or 'auto'}"
        cfg = _service_config(version, mode, batch, chunk_mb, platform)
        dcz = os.path.join(workdir, f"svc_v{version}_{mode}_{batch}.dcz")
        out = dcz + ".out"
        with DeviceCompressionService(cfg) as svc:
            host_decodes = []
            cpu_decode = svc._codec._cpu.decode_chunk

            def counting_decode(*a, **k):
                host_decodes.append(1)
                return cpu_decode(*a, **k)

            svc._codec._cpu.decode_chunk = counting_decode
            t0 = time.perf_counter()
            svc.compress(src, dcz)
            t_c = time.perf_counter() - t0
            log(f"{tag}: compress {t_c:.2f} s (first call, compiles included), "
                f"ratio {os.path.getsize(dcz) / size:.4f}")
            log(svc.get_last_stage_metrics().summary())
            t0 = time.perf_counter()
            if not svc.verify_integrity(dcz, deep=True):
                raise AssertionError(f"{tag}: deep verify failed")
            t_v = time.perf_counter() - t0
            n_verify_host = len(host_decodes)
            t0 = time.perf_counter()
            svc.decompress(dcz, out)
            t_d = time.perf_counter() - t0
            log(f"{tag}: deep verify {t_v:.2f} s, decompress {t_d:.2f} s")
            log(svc.get_last_stage_metrics().summary())
            assert_same_file(src, out, f"{tag} round trip")
            routes, missed = _count_routes(svc, dcz)
            if missed:
                raise AssertionError(
                    f"{tag}: chunks {missed} have codes <= 16 bits but no device plan"
                )
            n_host = len(host_decodes) - n_verify_host
            if n_host != routes["host"]:
                raise AssertionError(
                    f"{tag}: {n_host} host decodes, expected {routes['host']}"
                )
            stats = svc._codec.freq._ensure_device().memory_stats() or {}
            log(f"{tag}: round trip exact; decode routes {routes}; device peak "
                f"so far {_mb(stats.get('peak_bytes_in_use', 0))}")
        if version == 1:
            ref = dcz + ".cpu.dcz"
            with CpuCompressionService(cfg) as cpu:
                cpu.compress(src, ref)
            assert_same_file(dcz, ref, f"{tag} vs CPU service")
            log(f"{tag}: .dcz byte-identical to the CPU service's")
        os.remove(out)


# -- phase: cli ---------------------------------------------------------------


def phase_cli(file_mb: int = SERVICE_FILE_MB, backend: str = "gpu",
              workdir: str = "."):
    from datacomp.cli import main as dcz
    from datacomp.utils.testdata import write_mixed_file

    src = os.path.join(workdir, "mixed.bin")
    if not os.path.exists(src):
        write_mixed_file(src, file_mb)
    dcz_path = os.path.join(workdir, "cli.dcz")
    out = os.path.join(workdir, "cli.out")
    for argv in (
        ["compress", src, dcz_path, "--backend", backend, "--format", "2"],
        ["verify", dcz_path, "--backend", backend, "--deep"],
        ["decompress", dcz_path, out, "--backend", backend],
    ):
        t0 = time.perf_counter()
        rc = dcz(argv)
        log(f"\ndcz {argv[0]}: rc {rc}, {time.perf_counter() - t0:.2f} s")
        if rc != 0:
            raise AssertionError(f"dcz {' '.join(argv)} exited {rc}")
    assert_same_file(src, out, "cli round trip")
    log("cli: round trip exact")


# -- phase: cards -------------------------------------------------------------


def phase_cards(cards: int, file_mb: int = CARDS_FILE_MB, chunk_mb: int = CHUNK_MB,
                platform: str = "gpu", workdir: str = "."):
    import jax

    from datacomp.cli import main as dcz
    from datacomp.parallel import make_mesh
    from datacomp.parallel.multihost import (
        _shard_rows,
        compress_multihost,
        decompress_multihost,
    )
    from datacomp.parallel.sharded import make_sharded_compress_step
    from datacomp.services.device_service import DeviceCompressionService
    from datacomp.utils.testdata import generate_bytes, write_mixed_file

    devs = jax.devices(platform)
    if len(devs) < cards:
        raise AssertionError(f"need {cards} {platform} devices, have {len(devs)}")
    mesh = make_mesh(cards, devices=devs)
    log(f"mesh: {cards} x {devs[0].device_kind}")

    # the chunks of one group land one per card
    cfg = _service_config(2, "device", 1, chunk_mb, platform)
    chunk = cfg.chunk_size_bytes
    step = make_sharded_compress_step(mesh, chunk, cfg.compression.subblock_symbols)
    batch = np.stack([
        np.frombuffer(generate_bytes("text", chunk, seed=s), np.uint8)
        for s in range(cards)
    ])
    x, v = _shard_rows(mesh, batch, np.full(cards, chunk, np.int32))
    out = step(x, v)
    words, total_bits = out[3], out[4]
    shard_devs = {s.device for s in words.addressable_shards}
    if shard_devs != set(mesh.devices.flat) or any(
        s.data.shape[0] != 1 for s in words.addressable_shards
    ):
        raise AssertionError(f"chunks did not land one per card: {shard_devs}")
    log(f"sharded step: one chunk per card on {sorted(d.id for d in shard_devs)}, "
        f"total bits {np.asarray(total_bits).tolist()}")

    src = os.path.join(workdir, "mixed256.bin")
    write_mixed_file(src, file_mb)
    ref = os.path.join(workdir, "single.dcz")
    t0 = time.perf_counter()
    with DeviceCompressionService(cfg) as svc:
        svc.compress(src, ref)
    log(f"one-card service compress: {time.perf_counter() - t0:.2f} s")

    mesh_dcz = os.path.join(workdir, "mesh.dcz")
    t0 = time.perf_counter()
    compress_multihost(src, mesh_dcz, cfg, backend="gpu", mesh=mesh)
    log(f"compress_multihost over {cards} cards: {time.perf_counter() - t0:.2f} s")
    assert_same_file(mesh_dcz, ref, "mesh .dcz vs one-card service")
    restored = os.path.join(workdir, "mesh.out")
    t0 = time.perf_counter()
    decompress_multihost(mesh_dcz, restored, cfg, backend="gpu", mesh=mesh)
    log(f"decompress_multihost over {cards} cards: {time.perf_counter() - t0:.2f} s")
    assert_same_file(src, restored, "mesh round trip")

    cli_dcz = os.path.join(workdir, "cli_sharded.dcz")
    cli_out = os.path.join(workdir, "cli_sharded.out")
    backend = "gpu" if platform == "gpu" else "auto"  # auto: a CPU rehearsal
    for argv in (
        ["compress", src, cli_dcz, str(chunk_mb), "--sharded", "--backend", backend],
        ["decompress", cli_dcz, cli_out, str(chunk_mb), "--sharded", "--backend", backend],
    ):
        rc = dcz(argv)
        log(f"\ndcz {' '.join(argv[:1] + argv[4:])}: rc {rc}")
        if rc != 0:
            raise AssertionError(f"dcz {' '.join(argv)} exited {rc}")
    assert_same_file(cli_dcz, ref, "dcz --sharded .dcz vs one-card service")
    assert_same_file(src, cli_out, "dcz --sharded round trip")
    for d in mesh.devices.flat:
        stats = d.memory_stats() or {}
        log(f"card {d.id}: peak {_mb(stats.get('peak_bytes_in_use', 0))} in use")
    log(f"cards: {cards}-card output byte-identical to the one-card service; "
        "round trips exact")


# -- main ---------------------------------------------------------------------


PHASES = ("device", "ops", "service", "cli")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", choices=PHASES, action="append",
                    help="run only this phase (repeatable; default: all four)")
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the multi-GPU sharded phase on 4 cards")
    args = ap.parse_args(argv)

    import jax

    from datacomp.utils.card import card_line

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devs[0].platform})",
              file=sys.stderr)
        return 2
    card = card_line()
    if card is None:
        print("chip_smoke: nvidia-smi did not report the card", file=sys.stderr)
        return 2
    log(f"card: {card}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.cards > 1:
            phases = [("cards", lambda: phase_cards(args.cards, workdir=workdir))]
            count = args.cards
        else:
            todo = args.phase or list(PHASES)
            runners = {
                "device": phase_device,
                "ops": phase_ops,
                "service": lambda: phase_service(workdir=workdir),
                "cli": lambda: phase_cli(workdir=workdir),
            }
            phases = [(p, runners[p]) for p in PHASES if p in todo]
            count = 1
        for name, run in phases:
            t0 = time.perf_counter()
            log(f"== phase {name}")
            run()
            log(f"== phase {name}: passed in {time.perf_counter() - t0:.2f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.2f} s")
    log(card)  # exactly as nvidia-smi printed it
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
