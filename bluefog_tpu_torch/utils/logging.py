"""Leveled logging, controlled by the environment.

Counterpart of ``bluefog_tpu/utils/logging.py`` (the reference's
``bluefog/common/logging.{h,cc}``: ``BFLOG(level)`` gated by
``BLUEFOG_LOG_LEVEL``).  ``BLUEFOG_TPU_LOG_LEVEL`` in {trace, debug, info,
warn, error, fatal}, default ``warn``, the variable the native runtime's
``csrc/logging.cc`` reads too, mapped onto the stdlib logger
``bluefog_tpu_torch``.
"""

from __future__ import annotations

import logging as _pylogging
import os

__all__ = ["log"]

_LEVELS = {
    "trace": 5,
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "warn": _pylogging.WARNING,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "fatal": _pylogging.CRITICAL,
}

_pylogging.addLevelName(5, "TRACE")


class _Log:
    def __init__(self):
        self._logger = _pylogging.getLogger("bluefog_tpu_torch")
        level = os.environ.get("BLUEFOG_TPU_LOG_LEVEL", "warn").lower()
        self._logger.setLevel(_LEVELS.get(level, _pylogging.WARNING))
        if not self._logger.handlers:
            h = _pylogging.StreamHandler()
            h.setFormatter(_pylogging.Formatter(
                "[%(asctime)s %(levelname)s bluefog_tpu_torch] %(message)s"))
            self._logger.addHandler(h)
            self._logger.propagate = False

    def trace(self, msg, *args):
        self._logger.log(5, msg, *args)

    def debug(self, msg, *args):
        self._logger.debug(msg, *args)

    def info(self, msg, *args):
        self._logger.info(msg, *args)

    def warn(self, msg, *args):
        self._logger.warning(msg, *args)

    def error(self, msg, *args):
        self._logger.error(msg, *args)

    def set_level(self, level: str):
        self._logger.setLevel(_LEVELS.get(level.lower(), _pylogging.WARNING))


log = _Log()
