"""Structured logging — the analog of the reference's gr::logger
(runtime/include/gnuradio/logger.h, spdlog-backed). Python logging with a
per-node child-logger convention and one env-var level knob."""

from __future__ import annotations

import logging
import os

_ROOT = "newsched_tpu_torch"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("NEWSCHED_TPU_LOG", "WARNING").upper()
    logger = logging.getLogger(_ROOT)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
    logger.setLevel(getattr(logging, level, logging.WARNING))
    _configured = True


def get_logger(name: str | None = None) -> logging.Logger:
    """Per-node logger: get_logger("fir_filter_0")."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
