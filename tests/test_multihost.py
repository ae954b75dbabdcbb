"""Multi-host orchestration logic tests: simulate N hosts in one process —
striped assignment, gathered-size interleave, global offsets, disjoint pwrite
ranges, host-0 footer — and verify the assembled file decodes with the
standard single-host reader."""

import os

import numpy as np
import pytest

from datacomp.config import load_config
from datacomp.core import ChunkMeta, read_container
from datacomp.parallel.multihost import (
    ChunkAssignment,
    assemble_header,
    global_offsets,
    interleave_gathered,
    write_footer_host0,
    write_host_payloads,
)
from datacomp.services.cpu_service import CpuChunkCodec, CpuCompressionService
from datacomp.models import StageMetrics
from datacomp.utils.checksum import compute_sha256
from datacomp.utils.testdata import generate_bytes


def test_striped_assignment_covers_all():
    n_chunks, n_hosts = 11, 3
    seen = []
    for h in range(n_hosts):
        seen += ChunkAssignment(h, n_hosts, n_chunks).local_chunks()
    assert sorted(seen) == list(range(n_chunks))
    for ci in range(n_chunks):
        assert ChunkAssignment.owner_of(ci, n_hosts) == ci % n_hosts


def test_interleave_and_offsets():
    per_host = [[10, 40], [20, 50], [30]]  # host h owns chunks h, h+3, ...
    sizes = interleave_gathered(per_host, 5)
    assert list(sizes) == [10, 20, 30, 40, 50]
    offs = global_offsets(sizes)
    assert list(offs) == [0, 10, 30, 60, 100]


def test_simulated_multihost_compress(tmp_path):
    """3 simulated hosts compress a 5-chunk file; output must be identical to
    the single-host service's output and decode cleanly."""
    cfg = load_config(compression={"chunk_size_mb": 1})
    chunk = cfg.chunk_size_bytes
    data = generate_bytes("text", 4 * chunk + 12345)
    src = tmp_path / "mh.bin"
    src.write_bytes(data)
    n_chunks = 5
    n_hosts = 3

    codec = CpuChunkCodec(cfg)
    metrics = StageMetrics()

    # each "host" encodes its stripe
    per_host_payloads = {}
    per_host_metas = {}
    for h in range(n_hosts):
        assignment = ChunkAssignment(h, n_hosts, n_chunks).local_chunks()
        payloads, metas = [], []
        for ci in assignment:
            off = ci * chunk
            cd = np.frombuffer(data[off : off + chunk], np.uint8)
            enc = codec.encode_chunk(cd, metrics)
            payloads.append(enc.payload)
            metas.append((ci, off, cd.size, enc))
        per_host_payloads[h] = payloads
        per_host_metas[h] = metas

    # all-gather sizes -> global offsets (identical on every host)
    per_host_sizes = [
        [len(p) for p in per_host_payloads[h]] for h in range(n_hosts)
    ]
    sizes = interleave_gathered(per_host_sizes, n_chunks)
    offs = global_offsets(sizes)

    # each host pwrites its stripe
    out = str(tmp_path / "mh.dcz")
    open(out, "wb").close()
    for h in range(n_hosts):
        idxs = [m[0] for m in per_host_metas[h]]
        write_host_payloads(out, per_host_payloads[h], idxs, offs)

    # host 0 assembles metadata + footer
    metas_by_index = [None] * n_chunks
    for h in range(n_hosts):
        for ci, off, nsz, enc in per_host_metas[h]:
            metas_by_index[ci] = ChunkMeta(
                ci, off, nsz, int(offs[ci]), int(sizes[ci]), enc.sha256, enc.code_lengths
            )
    header = assemble_header(
        "mh.bin", len(data), int(os.path.getmtime(src) * 1000), chunk, metas_by_index
    )
    write_footer_host0(out, header, int(sizes.sum()))

    # the standard reader decodes it
    h2, data_start = read_container(out)
    assert data_start == 0 and h2.num_chunks == n_chunks
    svc = CpuCompressionService(cfg)
    restored = str(tmp_path / "mh.out")
    svc.decompress(out, restored)
    assert open(restored, "rb").read() == data
    assert svc.verify_integrity(out, deep=True)

    # byte-identical to the single-host service output
    ref = str(tmp_path / "ref.dcz")
    svc.compress(str(src), ref)
    assert open(out, "rb").read() == open(ref, "rb").read()
    svc.close()


def test_compress_multihost_single_process_identical(tmp_path):
    """compress_multihost degrades to a byte-identical single-host compress."""
    from datacomp.config import load_config
    from datacomp.parallel.multihost import compress_multihost
    from datacomp.services.cpu_service import CpuCompressionService
    from datacomp.utils.testdata import generate_bytes

    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 3 << 20) + generate_bytes("random", 1 << 20))
    for version in (1, 2):
        cfg = load_config(compression={"chunk_size_mb": 1, "format_version": version})
        with CpuCompressionService(cfg) as svc:
            svc.compress(str(src), str(tmp_path / "ref.dcz"))
        compress_multihost(str(src), str(tmp_path / "mh.dcz"), cfg)
        assert (tmp_path / "mh.dcz").read_bytes() == (tmp_path / "ref.dcz").read_bytes(), (
            f"v{version} multihost output differs from single-host"
        )


TWO_PROC_SCRIPT = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.distributed
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=2,
    process_id=int(sys.argv[2]),
)
from datacomp.config import load_config
from datacomp.parallel.multihost import compress_multihost, decompress_multihost
cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2})
compress_multihost(sys.argv[3], sys.argv[4], cfg)
decompress_multihost(sys.argv[4], sys.argv[5], cfg)
"""


def test_compress_multihost_two_processes(tmp_path):
    """REAL two-process run: jax.distributed over localhost, round-robin
    stripes, cross-process metadata allgather, disjoint pwrites, host-0
    footer.  Output must decompress byte-exactly with the normal service."""
    import socket
    import subprocess
    import sys

    from datacomp.config import load_config
    from datacomp.services.cpu_service import CpuCompressionService
    from datacomp.utils.testdata import generate_bytes

    src = tmp_path / "in.bin"
    src.write_bytes(
        generate_bytes("text", 2 << 20)
        + generate_bytes("skewed", 1 << 20)
        + generate_bytes("random", 1 << 20)
        + b"tail-bytes"
    )
    out = tmp_path / "mh2.dcz"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    script = tmp_path / "worker.py"
    script.write_text(TWO_PROC_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    mh_restored = tmp_path / "mh_restored.bin"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid), str(src), str(out),
             str(mh_restored)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("jax.distributed two-process run timed out on this host")
        if p.returncode != 0:
            pytest.fail(f"worker failed:\n{err.decode()[-2000:]}")
    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2})
    with CpuCompressionService(cfg) as svc:
        assert svc.verify_integrity(str(out), deep=True)
        svc.decompress(str(out), str(tmp_path / "restored.bin"))
    assert (tmp_path / "restored.bin").read_bytes() == src.read_bytes()
    # the workers' own two-process decompress_multihost leg (disjoint
    # pwrites at original offsets across processes) restored it too
    assert mh_restored.read_bytes() == src.read_bytes()


def test_compress_multihost_gpu_backend(tmp_path):
    """backend="gpu" encodes stripes with the device codec (CPU platform
    here) and still produces output identical to the CPU-codec path with a
    java-mode codebook."""
    from datacomp.config import load_config
    from datacomp.parallel.multihost import compress_multihost
    from datacomp.utils.testdata import generate_bytes

    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 2 << 20))
    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2})
    compress_multihost(str(src), str(tmp_path / "cpu.dcz"), cfg, backend="cpu")
    compress_multihost(str(src), str(tmp_path / "dev.dcz"), cfg, backend="gpu")
    assert (tmp_path / "dev.dcz").read_bytes() == (tmp_path / "cpu.dcz").read_bytes()


def test_compress_multihost_mesh_identical_to_single_host_service(tmp_path):
    """The flagship multi-chip axis: a virtual 8-device mesh encodes the
    stripe through ONE sharded device program per group
    (make_sharded_compress_step), and the output file is byte-identical to
    the single-host device service's — same raw-store routing (host pre-pass),
    same device codebooks, same encoded bits, same container."""
    from datacomp.config import load_config
    from datacomp.parallel import make_mesh
    from datacomp.parallel.multihost import compress_multihost
    from datacomp.services.device_service import DeviceCompressionService

    src = tmp_path / "in.bin"
    # 3 full chunks + ragged tail; one random chunk exercises raw-store
    # routing around the mesh step
    src.write_bytes(
        generate_bytes("text", 1 << 20)
        + generate_bytes("random", 1 << 20)
        + generate_bytes("skewed", 1 << 20)
        + generate_bytes("compressible", 12345)
    )
    cfg = load_config(
        compression={
            "chunk_size_mb": 1, "format_version": 2, "codebook_mode": "device",
        }
    )
    ref = tmp_path / "single.dcz"
    with DeviceCompressionService(cfg) as svc:
        svc.compress(str(src), str(ref))

    mesh = make_mesh(8)
    out = tmp_path / "mesh.dcz"
    compress_multihost(str(src), str(out), cfg, backend="gpu", mesh=mesh)
    assert out.read_bytes() == ref.read_bytes(), (
        "mesh-sharded multihost output differs from the single-host service"
    )

    with CpuCompressionService(cfg) as svc:
        assert svc.verify_integrity(str(out), deep=True)
        svc.decompress(str(out), str(tmp_path / "restored.bin"))
    assert (tmp_path / "restored.bin").read_bytes() == src.read_bytes()


def test_decompress_multihost_single_process_identical(tmp_path):
    """decompress_multihost (CPU backend) restores bytes identical to the
    single-host service for both container versions."""
    from datacomp.parallel.multihost import compress_multihost, decompress_multihost

    blob = (
        generate_bytes("text", 2 << 20)
        + generate_bytes("random", 1 << 20)
        + generate_bytes("compressible", 7777)
    )
    src = tmp_path / "in.bin"
    src.write_bytes(blob)
    for version in (1, 2):
        cfg = load_config(compression={"chunk_size_mb": 1, "format_version": version})
        dcz = tmp_path / f"v{version}.dcz"
        compress_multihost(str(src), str(dcz), cfg)
        out = tmp_path / f"v{version}.out"
        decompress_multihost(str(dcz), str(out), cfg)
        assert out.read_bytes() == blob, f"v{version} multihost decompress mismatch"


def test_decompress_multihost_mesh_mixed_corpus(tmp_path):
    """The round-5 symmetric axis: a virtual 8-device mesh decodes the stripe
    through ONE sharded device program per group, with raw-store chunks and a
    DEEP-codebook chunk (>16-bit codes, host-delegated) routed around it and
    a ragged tail — restored bytes must equal the source byte-for-byte."""
    from datacomp.models import StageMetrics
    from datacomp.parallel import make_mesh
    from datacomp.parallel.multihost import decompress_multihost

    # fib-skewed chunk forces >16-bit code lengths (the host-delegation path)
    fib = [1, 1]
    while len(fib) < 24:
        fib.append(fib[-1] + fib[-2])
    deep = b"".join(bytes([s]) * c for s, c in enumerate(fib))
    deep = (deep * ((1 << 20) // len(deep) + 1))[: 1 << 20]
    blob = (
        generate_bytes("text", 1 << 20)
        + generate_bytes("random", 1 << 20)
        + deep
        + generate_bytes("compressible", 54321)
    )
    src = tmp_path / "in.bin"
    src.write_bytes(blob)
    # max_code_len=32 opts out of the auto depth cap so the deep chunk keeps
    # its >16-bit codes (otherwise every chunk would be device-decodable)
    cfg = load_config(
        compression={"chunk_size_mb": 1, "format_version": 2, "max_code_len": 32}
    )
    dcz = tmp_path / "mix.dcz"
    with CpuCompressionService(cfg) as svc:
        svc.compress(str(src), str(dcz))
    header, _ = read_container(str(dcz))
    mls = [int(c.code_lengths.max()) for c in header.chunks]
    assert max(mls) > 16, "fixture no longer produces a deep-codebook chunk"
    assert any(0 < ml <= 16 for ml in mls), "no device-decodable chunk in fixture"

    out = tmp_path / "mix.out"
    metrics = StageMetrics()
    fracs = []
    decompress_multihost(
        str(dcz), str(out), cfg, backend="gpu", mesh=make_mesh(8),
        progress=fracs.append, metrics=metrics,
    )
    assert out.read_bytes() == blob, "mesh decompress mismatch"
    assert fracs and fracs[-1] == 1.0
    from datacomp.models import Stage

    assert metrics.count(Stage.DECODING) > 0


def test_compress_multihost_progress_and_metrics(tmp_path):
    """compress_multihost reports progress over the local stripe and fills
    the same stage cards as the single-host service (round-4 weak #2)."""
    from datacomp.models import Stage, StageMetrics
    from datacomp.parallel.multihost import compress_multihost

    src = tmp_path / "in.bin"
    src.write_bytes(generate_bytes("text", 2 << 20) + b"x" * 100)
    cfg = load_config(compression={"chunk_size_mb": 1, "format_version": 2})
    metrics = StageMetrics()
    fracs = []
    compress_multihost(
        str(src), str(tmp_path / "o.dcz"), cfg, progress=fracs.append,
        metrics=metrics,
    )
    assert fracs == sorted(fracs) and fracs[-1] == 1.0
    for stage in (Stage.CHECKSUM_COMPUTE, Stage.ENCODING, Stage.FILE_IO,
                  Stage.HEADER_WRITE):
        assert metrics.count(stage) > 0, f"{stage} not attributed"
    # no stray spill file left behind
    assert not list(tmp_path.glob("*.spill*"))


BOUNDED_RSS_SCRIPT = r"""
import os, resource, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.device_count()  # force backend init before the baseline RSS sample
from datacomp.config import load_config
from datacomp.parallel.multihost import compress_multihost, decompress_multihost
cfg = load_config(compression={"chunk_size_mb": 16, "format_version": 2})
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
compress_multihost(sys.argv[1], sys.argv[2], cfg)
peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
decompress_multihost(sys.argv[2], sys.argv[3], cfg)
dpeak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(f"{peak - before:.0f} {dpeak - peak:.0f}")
"""


def test_compress_multihost_bounded_rss(tmp_path):
    """The payload spill keeps per-host RSS O(group × chunk), not O(stripe):
    compressing a 192 MB text file (~100 MB of payload) in a clean subprocess
    must not grow peak RSS by more than a few chunks' worth (round-4 weak #2:
    the old list-of-payloads held the whole stripe)."""
    import subprocess
    import sys

    src = tmp_path / "big.bin"
    block = generate_bytes("text", 16 << 20)
    with open(src, "wb") as f:
        for _ in range(12):  # 192 MB
            f.write(block)
    script = tmp_path / "rss_probe.py"
    script.write_text(BOUNDED_RSS_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dcz, out = tmp_path / "big.dcz", tmp_path / "big.out"
    proc = subprocess.run(
        [sys.executable, str(script), str(src), str(dcz), str(out)],
        env=env, capture_output=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    growth_mb, dec_growth_mb = (float(x) for x in proc.stdout.split())
    # single process, group=1, 16 MB chunks: working set is a handful of
    # chunk-sized buffers; the unbounded formulation grew by the ~100 MB
    # compressed stripe
    assert growth_mb < 80, f"compress grew peak RSS by {growth_mb:.0f} MB"
    assert dec_growth_mb < 80, f"decompress grew peak RSS by {dec_growth_mb:.0f} MB"
    assert out.read_bytes() == src.read_bytes()
