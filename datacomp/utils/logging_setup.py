"""Logging configuration (parity: the reference's logback setup,
``resources/logback.xml:4-45``): console handler + optional daily-rolling file
handler + a dedicated metrics logger that appends one line per operation to
``logs/metrics.log`` when enabled."""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

from ..config import AppConfig

METRICS_LOGGER_NAME = "datacomp.metrics"
_configured = False


def setup_logging(config: Optional[AppConfig] = None, force: bool = False) -> None:
    global _configured
    if _configured and not force:
        return
    from ..config import load_config

    config = config or load_config()
    level = getattr(logging, config.logging.level.upper(), logging.INFO)
    root = logging.getLogger("datacomp")
    root.setLevel(level)
    root.handlers.clear()

    console = logging.StreamHandler()
    console.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-5s [%(name)s] %(message)s", "%H:%M:%S")
    )
    root.addHandler(console)

    if config.logging.file_path:
        os.makedirs(os.path.dirname(config.logging.file_path) or ".", exist_ok=True)
        fileh = logging.handlers.TimedRotatingFileHandler(
            config.logging.file_path, when="midnight", backupCount=7
        )
        fileh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-5s [%(name)s] %(message)s")
        )
        root.addHandler(fileh)

    if config.logging.metrics_enabled:
        mlog = logging.getLogger(METRICS_LOGGER_NAME)
        mlog.setLevel(logging.INFO)
        mlog.propagate = False
        if config.logging.file_path:
            mdir = os.path.dirname(config.logging.file_path) or "."
        else:
            mdir = "logs"
        try:
            os.makedirs(mdir, exist_ok=True)
            mh = logging.FileHandler(os.path.join(mdir, "metrics.log"))
            mh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
            mlog.handlers.clear()
            mlog.addHandler(mh)
        except OSError:
            pass
        # wire the in-process MetricsService to the metrics log
        from ..models import MetricsService

        def _log_metric(m):
            logging.getLogger(METRICS_LOGGER_NAME).info(
                "%s %s %d -> %d bytes  %.2f MB/s  [%s]",
                m.operation.value, m.file_name, m.original_size,
                m.processed_size, m.throughput_mbps, m.backend,
            )

        MetricsService.get_instance().add_listener(_log_metric)
    _configured = True
