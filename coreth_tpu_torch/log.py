"""Leveled chain logger (coreth's geth log routed into the avalanchego
chain logger, plugin/evm/vm.go:344-353 and plugin/evm/log.go); counterpart
of coreth_tpu/log.py.

One process-wide logger namespace ("coreth_tpu_torch") with the reference's
level vocabulary (trace/debug/info/warn/error/crit) and optional JSON
line output; AdminAPI.setLogLevel drives set_level at runtime."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

_LEVELS = {
    "trace": TRACE,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "crit": logging.CRITICAL,
}

_root = logging.getLogger("coreth_tpu_torch")
_handler: Optional[logging.Handler] = None


class _JSONFormatter(logging.Formatter):
    def format(self, record):
        out = {
            "t": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "lvl": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.__dict__.get("ctx"):
            out.update(record.__dict__["ctx"])
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=repr)


def init(level: str = "info", json_format: bool = False,
         stream=None) -> None:
    """Install the handler (idempotent; re-init swaps format/level)."""
    global _handler
    if _handler is not None:
        _root.removeHandler(_handler)
    _handler = logging.StreamHandler(stream or sys.stderr)
    if json_format:
        _handler.setFormatter(_JSONFormatter())
    else:
        _handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        ))
    _root.addHandler(_handler)
    _root.propagate = False
    set_level(level)


def set_level(level: str) -> None:
    """admin.setLogLevel surface; raises on unknown levels (log.go)."""
    lv = _LEVELS.get(level)
    if lv is None:
        raise ValueError(f"unknown log level {level!r}")
    _root.setLevel(lv)


def get_logger(name: str = "") -> logging.Logger:
    """Module loggers: get_logger("sync") -> coreth_tpu_torch.sync."""
    return _root.getChild(name) if name else _root


def trace(logger: logging.Logger, msg: str, **ctx) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, extra={"ctx": ctx})


def debug(logger: logging.Logger, msg: str, **ctx) -> None:
    if logger.isEnabledFor(logging.DEBUG):
        logger.log(logging.DEBUG, msg, extra={"ctx": ctx})


def info(logger: logging.Logger, msg: str, **ctx) -> None:
    if logger.isEnabledFor(logging.INFO):
        logger.log(logging.INFO, msg, extra={"ctx": ctx})


def warn(logger: logging.Logger, msg: str, **ctx) -> None:
    if logger.isEnabledFor(logging.WARNING):
        logger.log(logging.WARNING, msg, extra={"ctx": ctx})


def error(logger: logging.Logger, msg: str, exc_info=None, **ctx) -> None:
    if logger.isEnabledFor(logging.ERROR):
        logger.log(logging.ERROR, msg, exc_info=exc_info,
                   extra={"ctx": ctx})
