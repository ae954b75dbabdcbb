"""Backend selection (parity: ``service/ServiceFactory.java:21-70``):
force_cpu → CPU; otherwise probe the GPU service and fall back to the CPU
codec when there is no usable GPU.  The device service on a CPU JAX device is
never handed out here as the accelerator."""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Optional

from ..config import AppConfig, load_config
from .base import CompressionService, FrequencyService
from .cpu_service import CpuCompressionService, CpuFrequencyService

logger = logging.getLogger(__name__)


def _on_gpu(config: AppConfig) -> AppConfig:
    return replace(config, device=replace(config.device, platform="gpu"))


def create_compression_service(
    config: Optional[AppConfig] = None, force_cpu: Optional[bool] = None
) -> CompressionService:
    config = config or load_config()
    if force_cpu if force_cpu is not None else config.device.force_cpu:
        logger.info("Using CPU compression service (forced)")
        return CpuCompressionService(config)
    if config.device.auto_detect:
        try:
            from .device_service import DeviceCompressionService

            svc = DeviceCompressionService(_on_gpu(config))
            if svc.is_available():
                logger.info("Using GPU compression service")
                return svc
            svc.close()
            logger.warning("GPU probe failed; using CPU compression service")
        except Exception as e:  # noqa: BLE001 — reference parity: no usable GPU ⇒ CPU
            logger.info("no GPU available (%s); using CPU compression service", e)
    return CpuCompressionService(config)


def create_frequency_service(
    config: Optional[AppConfig] = None, force_cpu: Optional[bool] = None
) -> FrequencyService:
    config = config or load_config()
    if force_cpu if force_cpu is not None else config.device.force_cpu:
        return CpuFrequencyService()
    try:
        from .device_service import DeviceFrequencyService

        svc = DeviceFrequencyService(_on_gpu(config))
        if svc.is_available():
            return svc
    except Exception as e:  # noqa: BLE001
        logger.info("no GPU frequency service (%s); using CPU", e)
    return CpuFrequencyService()
