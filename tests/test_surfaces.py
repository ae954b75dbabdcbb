"""Dashboard / logging / config / testdata surface tests."""

import logging
import os

import numpy as np
import pytest

from datacomp.config import load_config
from datacomp.models import CompressionMetrics, MetricsService, OperationType
from datacomp.ui import export_html, render_dashboard
from datacomp.ui.dashboard import sparkline
from datacomp.utils.testdata import JavaRandom, generate_bytes, java_random_bytes


@pytest.fixture
def populated_metrics():
    ms = MetricsService()
    for i in range(5):
        ms.add_metrics(
            CompressionMetrics(
                f"file{i}.bin", OperationType.COMPRESSION, 1000 * (i + 1),
                400 * (i + 1), 0.01 * (i + 1), "CPU",
            )
        )
    return ms


class TestDashboard:
    def test_render_empty(self):
        out = render_dashboard(MetricsService())
        assert "datacomp dashboard" in out
        assert "No operations recorded" in out

    def test_render_populated(self, populated_metrics):
        out = render_dashboard(populated_metrics)
        assert "file4.bin" in out
        assert "Throughput history" in out
        assert "MB/s" in out

    def test_html_export(self, tmp_path, populated_metrics):
        p = str(tmp_path / "report.html")
        export_html(p, populated_metrics)
        html = open(p).read()
        assert "<table>" in html and "file0.bin" in html
        assert html.count('class="bar"') == 5

    def test_html_themes(self, tmp_path, populated_metrics):
        # parity with the reference's dark/light CSS theme pair
        p = str(tmp_path / "report.html")
        export_html(p, populated_metrics, theme="dark")
        assert "--bg:#14151a" in open(p).read()
        export_html(p, populated_metrics, theme="light")
        assert "--bg:#f7f7f5" in open(p).read()
        export_html(p, populated_metrics, theme="auto")
        assert "prefers-color-scheme" in open(p).read()
        import pytest

        with pytest.raises(ValueError):
            export_html(p, populated_metrics, theme="sepia")

    def test_sparkline(self):
        assert sparkline([]) == ""
        s = sparkline([0.0, 1.0, 2.0, 4.0])
        assert len(s) == 4
        assert s[-1] == "█"


class TestConfig:
    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("DATACOMP_COMPRESSION_CHUNK_SIZE_MB", "7")
        monkeypatch.setenv("DATACOMP_DEVICE_FORCE_CPU", "true")
        cfg = load_config()
        assert cfg.compression.chunk_size_mb == 7
        assert cfg.device.force_cpu is True

    def test_toml_file(self, tmp_path):
        p = tmp_path / "cfg.toml"
        p.write_text(
            "[datacomp.compression]\nchunk-size-mb = 3\n"
            "[datacomp.output]\ncompressed-extension = '.dz2'\n"
        )
        cfg = load_config(str(p))
        assert cfg.compression.chunk_size_mb == 3
        assert cfg.output.compressed_extension == ".dz2"

    def test_override_precedence(self, tmp_path, monkeypatch):
        p = tmp_path / "cfg.toml"
        p.write_text("[datacomp.compression]\nchunk-size-mb = 3\n")
        monkeypatch.setenv("DATACOMP_COMPRESSION_CHUNK_SIZE_MB", "5")
        cfg = load_config(str(p), compression={"chunk_size_mb": 9})
        assert cfg.compression.chunk_size_mb == 9  # kwargs beat env beat file

    def test_effective_threads_clamped(self):
        cfg = load_config()
        assert 2 <= cfg.effective_cpu_threads() <= 8
        cfg = load_config(compression={"cpu_threads": 3})
        assert cfg.effective_cpu_threads() == 3

    def test_central_validation(self, caplog):
        import pytest

        with pytest.raises(ValueError, match="codebook-mode"):
            load_config(compression={"codebook_mode": "bogus"})
        with pytest.raises(ValueError, match="max-code-len"):
            load_config(compression={"max_code_len": 99})
        with pytest.raises(ValueError, match="subblock"):
            load_config(compression={"format_version": 2, "subblock_symbols": 100})
        # max_code_len × device mode warns once, centrally, for ALL backends
        with caplog.at_level(logging.WARNING, logger="datacomp.config"):
            load_config(compression={"max_code_len": 12, "codebook_mode": "device"})
        assert any("ignored in codebook_mode='device'" in r.message for r in caplog.records)


class TestLogging:
    def test_setup_and_metrics_log(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        from datacomp.utils import logging_setup

        logging_setup._configured = False
        cfg = load_config(
            logging={"file_path": str(tmp_path / "logs" / "dc.log"), "metrics_enabled": True}
        )
        logging_setup.setup_logging(cfg, force=True)
        logging.getLogger("datacomp.test").info("hello")
        MetricsService.get_instance().add_metrics(
            CompressionMetrics("x.bin", OperationType.COMPRESSION, 10, 5, 0.1, "CPU")
        )
        for h in logging.getLogger("datacomp.metrics").handlers:
            h.flush()
        mlog = tmp_path / "logs" / "metrics.log"
        assert mlog.exists()
        assert "x.bin" in mlog.read_text()
        MetricsService.reset_instance()


class TestTestData:
    def test_java_random_deterministic(self):
        assert java_random_bytes(100) == java_random_bytes(100)
        assert java_random_bytes(100, seed=1) != java_random_bytes(100, seed=2)

    def test_known_java_vector(self):
        """First bytes of new Random(42).nextBytes match the JDK: the LCG
        is specified in the Java SE docs, so this is a fixed vector."""
        r = JavaRandom(42)
        got = list(r.next_bytes(8))
        # state0 = (42 ^ 0x5DEECE66D); two nextInt() draws, little-endian bytes
        s = (42 ^ 0x5DEECE66D) & ((1 << 48) - 1)
        want = []
        for _ in range(2):
            s = (s * 0x5DEECE66D + 0xB) & ((1 << 48) - 1)
            v = s >> 16
            want += [(v >> (8 * i)) & 0xFF for i in range(4)]
        assert got == want

    def test_generate_kinds(self):
        for kind in ["random", "compressible", "text", "zeros", "skewed"]:
            b = generate_bytes(kind, 1000)
            assert len(b) == 1000
        h = np.bincount(np.frombuffer(generate_bytes("text", 50_000), np.uint8), minlength=256)
        assert h.max() > h[h > 0].min() * 3  # skewed distribution


class TestInteractiveApp:
    """Headless tests for the 4-view terminal app (`dcz ui`) — the pure
    renderers and key state machine (curses driver excluded)."""

    def _state(self):
        from datacomp.ui.app import AppState

        return AppState()

    def test_view_navigation_and_render(self):
        from datacomp.ui.app import handle_key, render_view

        st = self._state()
        for key, name in zip("1234", ("dashboard", "Compress", "Benchmark", "Settings")):
            handle_key(st, key)
            text = "\n".join(render_view(st))
            assert name in text
        handle_key(st, "q")
        assert st.quit

    def test_compress_view_text_entry_and_validation(self, tmp_path):
        from datacomp.ui.app import KEY_BACKSPACE, KEY_ENTER, KEY_TAB, handle_key

        st = self._state()
        handle_key(st, "2")
        for ch in "/no/such/file":
            handle_key(st, ch)
        assert st.input_path == "/no/such/file"
        handle_key(st, KEY_BACKSPACE)
        assert st.input_path == "/no/such/fil"
        handle_key(st, KEY_TAB)
        assert st.field_focus == 1
        handle_key(st, KEY_TAB)
        handle_key(st, KEY_ENTER)  # start on a missing file → message, no thread
        assert "not found" in st.op.message

    def test_compress_runs_end_to_end(self, tmp_path):
        import time

        from datacomp.ui.app import KEY_ENTER, handle_key, render_view
        from datacomp.utils.testdata import generate_bytes

        src = tmp_path / "ui.bin"
        src.write_bytes(generate_bytes("text", 200_000))
        st = self._state()
        st.settings["backend"] = "cpu"
        st.settings["chunk_size_mb"] = "1"
        handle_key(st, "2")
        st.input_path = str(src)
        handle_key(st, KEY_ENTER)
        for _ in range(200):
            if not st.op.running:
                break
            time.sleep(0.05)
        assert st.op.message.startswith("done:"), st.op.message
        assert (tmp_path / "ui.bin.dcz").exists()
        text = "\n".join(render_view(st))
        assert "MB/s" in st.op.message and "Encoding" in text  # stage breakdown

    def test_settings_cycle_and_save(self, tmp_path, monkeypatch):
        from datacomp.config import load_config
        from datacomp.ui.app import KEY_DOWN, KEY_RIGHT, handle_key

        monkeypatch.chdir(tmp_path)
        st = self._state()
        handle_key(st, "4")
        handle_key(st, KEY_RIGHT)  # chunk 16 -> 32
        assert st.settings["chunk_size_mb"] == "32"
        handle_key(st, KEY_DOWN)
        handle_key(st, KEY_RIGHT)  # format 2 -> 1
        assert st.settings["format_version"] == "1"
        handle_key(st, "s")
        assert "saved" in st.settings_saved
        cfg = load_config(str(tmp_path / "datacomp.toml"))
        assert cfg.compression.chunk_size_mb == 32
        assert cfg.compression.format_version == 1
