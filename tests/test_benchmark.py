"""Benchmark suite tests (parity: ``BenchmarkSuiteTest.java`` — full suite on
a small generated file, throughput > 0; plus the JSON/CSV formats the
reference declared but never implemented)."""

import json

import pytest

from datacomp.benchmark import BenchmarkSuite
from datacomp.config import load_config


@pytest.fixture(scope="module")
def results():
    cfg = load_config(
        compression={"chunk_size_mb": 1},
        benchmark={"warmup_iterations": 1, "measurement_iterations": 2},
    )
    suite = BenchmarkSuite(cfg)
    return suite, suite.run_full_suite(size_mb=1)


def test_full_suite_runs(results):
    suite, res = results
    assert len(res) >= 2  # at least CPU compress+decompress
    for r in res:
        assert r.throughput_mbps > 0
        assert r.mean_s > 0
    comp = [r for r in res if r.operation == "compress"]
    assert all(0 < r.compression_ratio < 1.5 for r in comp)


def test_console_format(results):
    suite, res = results
    text = suite.format_results(res, "console")
    assert "Benchmark Results" in text and "MB/s" in text


def test_json_format(results):
    suite, res = results
    data = json.loads(suite.format_results(res, "json"))
    assert "results" in data and len(data["results"]) == len(res)


def test_csv_format(results):
    suite, res = results
    lines = suite.format_results(res, "csv").splitlines()
    assert lines[0].startswith("service,operation")
    assert len(lines) == len(res) + 1


def test_metrics_models():
    from datacomp.models import (
        CompressionMetrics,
        MetricsService,
        OperationType,
        Stage,
        StageMetrics,
    )

    sm = StageMetrics()
    sm.record_stage(Stage.ENCODING, 1_000_000, 500)
    sm.record_stage(Stage.ENCODING, 1_000_000, 500)
    assert sm.count(Stage.ENCODING) == 2
    assert sm.bytes_processed(Stage.ENCODING) == 1000
    assert "Encoding" in sm.summary()

    m = CompressionMetrics("f", OperationType.COMPRESSION, 1000, 400, 0.1, "CPU")
    assert abs(m.compression_ratio - 0.4) < 1e-9
    assert abs(m.space_saved_percent - 60.0) < 1e-9

    ms = MetricsService()
    seen = []
    ms.add_listener(seen.append)
    ms.add_metrics(m)
    assert seen == [m]
    assert ms.get_last() is m
    assert ms.average_throughput_mbps(OperationType.COMPRESSION) > 0


def test_kernel_microbench_runs():
    """Slope-timed kernel microbench executes on the CPU platform and
    returns sane numbers for every kernel."""
    from datacomp.benchmark.kernels import format_kernel_results, run_kernel_bench

    res = run_kernel_bench(size_mb=1, kind="text", k_points=(1, 2), repeats=1)
    assert {"histogram", "codebook", "encode", "decode"} <= set(res)
    for name, r in res.items():
        if name.startswith("_"):
            continue
        assert r["ms_per_chunk"] > 0, name
    # roofline fields: bound + efficiency for every byte-rated kernel
    for name in ("histogram", "encode", "decode"):
        assert res[name]["bound_mbps"] and res[name]["bound_mbps"] > 0
        assert res[name]["efficiency"] is not None
    assert res["_primitives"]["gather_ns"] > 0
    text = format_kernel_results(res, 1)
    assert "histogram" in text and "decode" in text
    js = format_kernel_results(res, 1, "json")
    import json

    assert json.loads(js)["chunk_mb"] == 1


def test_corpus_bench(tmp_path):
    """Corpus generator + benchmark: every generated type round-trips, ratios
    land at/above their order-0 entropy bound, typed files compare against
    the reference's published table (``dcz bench --corpus``)."""
    from datacomp.benchmark.corpus import format_corpus_results, run_corpus_bench
    from datacomp.utils.testdata import generate_corpus

    d = tmp_path / "corpus"
    written = generate_corpus(str(d), scale=0.02)  # ~1.3 MB total
    assert len(written) == 7
    report = run_corpus_bench(str(d))
    assert len(report["files"]) == 7
    for r in report["files"]:
        # a correct Huffman coder sits between the entropy bound and bound+3%
        assert r["ratio"] >= r["entropy_bound_ratio"] - 1e-6, r
        assert r["ratio"] <= r["entropy_bound_ratio"] + 0.03, r
        assert r["kind"] is not None
    typed = [r for r in report["files"] if r["beats_reference"] is not None]
    assert typed and all(r["beats_reference"] for r in typed)
    text = format_corpus_results(report)
    assert "TOTAL" in text
    csv = format_corpus_results(report, "csv")
    assert csv.splitlines()[0].startswith("file,")
    import json as _json

    js = _json.loads(format_corpus_results(report, "json"))
    assert js["totals"]["ratio"] > 0
