"""Logging, the equivalent of the reference's fmt-macro logger.

A copy of prosper_tpu/utils/logger.py (LOG_INFO/WARN/ERR of the
reference's utils/Logger.hpp:39-48) under the logger name
"prosper_tpu_torch", which the port's modules log under
(logging.getLogger(__name__)).
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("prosper_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter("[%(levelname).1s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)


def log_info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def log_warn(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def log_error(msg: str, *args) -> None:
    _logger.error(msg, *args)
