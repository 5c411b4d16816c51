"""Structured logging: four severities on top of Python logging.

A copy of ``feature_detector_tpu/utils/log.py`` (the port imports nothing of
the JAX package): the same severities and format, with colours when the
stream is a TTY, on a logger of the port's own name.
"""

from __future__ import annotations

import logging
import sys

_RESET = "\033[0m"
_COLORS = {
    logging.DEBUG: "\033[90m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
}


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool):
        super().__init__("%(levelname).1s %(asctime)s %(name)s] %(message)s", "%H:%M:%S")
        self._use_color = use_color

    def format(self, record):
        msg = super().format(record)
        if self._use_color:
            color = _COLORS.get(record.levelno)
            if color:
                return f"{color}{msg}{_RESET}"
        return msg


_logger = logging.getLogger("feature_detector_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(_ColorFormatter(use_color=sys.stderr.isatty()))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def set_level(level) -> None:
    _logger.setLevel(level)


def report_debug(msg: str, *args) -> None:
    _logger.debug(msg, *args)


def report_info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def report_warn(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def report_error(msg: str, *args) -> None:
    _logger.error(msg, *args)


def report_text(msg: str, *args) -> None:
    """Raw text to stdout, no decoration."""
    print(msg % args if args else msg)
