"""Logging shim, the analogue of the reference's futile.logger usage.

Copied from infercnv_tpu/utils/logging.py (all of it), under the logger
name ``infercnv_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("infercnv_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("%(levelname)s [%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def set_debug(debug: bool = True) -> None:
    _logger.setLevel(logging.DEBUG if debug else logging.INFO)


def set_log_file(path: str) -> None:
    """Also write log records to a file (CLI --log_file)."""
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter("%(levelname)s [%(asctime)s] %(message)s", "%Y-%m-%d %H:%M:%S"))
    _logger.addHandler(h)


def log_info(msg: str) -> None:
    _logger.info(msg)


def log_warn(msg: str) -> None:
    _logger.warning(msg)


def log_error(msg: str) -> None:
    _logger.error(msg)


def log_debug(msg: str) -> None:
    _logger.debug(msg)
