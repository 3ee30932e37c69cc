"""Tiny structured logger for launcher/bench diagnostics.

Replaces bare ``print()`` calls so output carries a level, a component
name, and (in multihost workers) the worker id — while keeping stdout
clean: log lines go to **stderr**, so the parent's ``MH_RESULT `` stdout
parsing is untouched.

Level comes from ``REPRO_LOG`` (debug|info|warn|error, default info).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict

__all__ = ["get_logger", "Logger", "LOG_ENV"]

LOG_ENV = "REPRO_LOG"
_LEVELS = {"debug": 10, "info": 20, "warn": 30, "warning": 30, "error": 40}


def _threshold() -> int:
    return _LEVELS.get(os.environ.get(LOG_ENV, "info").strip().lower(), 20)


def _worker_prefix() -> str:
    wid = os.environ.get("REPRO_MH_PROCESS_ID")
    return f"w{wid}|" if wid is not None else ""


class Logger:
    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def _emit(self, level: str, msg: str, fields: Dict[str, Any]) -> None:
        if _LEVELS[level] < _threshold():
            return
        extra = "".join(f" {k}={v}" for k, v in fields.items())
        ts = time.strftime("%H:%M:%S")
        print(f"{ts} {level.upper():5s} [{_worker_prefix()}{self.name}] {msg}{extra}",
              file=sys.stderr, flush=True)

    def debug(self, msg: str, **fields: Any) -> None:
        self._emit("debug", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._emit("info", msg, fields)

    def warn(self, msg: str, **fields: Any) -> None:
        self._emit("warn", msg, fields)

    def error(self, msg: str, **fields: Any) -> None:
        self._emit("error", msg, fields)


_loggers: Dict[str, Logger] = {}


def get_logger(name: str) -> Logger:
    lg = _loggers.get(name)
    if lg is None:
        lg = _loggers[name] = Logger(name)
    return lg
