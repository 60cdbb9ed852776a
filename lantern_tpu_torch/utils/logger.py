"""Leveled, labeled logger (parity with lantern_cli/src/logger/mod.rs).

The reference prints `[label] [LEVEL] message` with a level filter; same
shape here, onto stderr, plus an optional callback hook for services.
"""

from __future__ import annotations

import enum
import sys
import time


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3


class Logger:
    def __init__(self, label: str, level: LogLevel = LogLevel.INFO, stream=None):
        self.label = label
        self.level = level
        self.stream = stream or sys.stderr
        self.hook = None  # optional callable(level, msg)

    def _log(self, level: LogLevel, msg: str):
        if level < self.level:
            return
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        print(f"[{self.label}] [{level.name}] [{ts}] {msg}", file=self.stream)
        if self.hook:
            self.hook(level, msg)

    def debug(self, msg: str):
        self._log(LogLevel.DEBUG, msg)

    def info(self, msg: str):
        self._log(LogLevel.INFO, msg)

    def warn(self, msg: str):
        self._log(LogLevel.WARN, msg)

    def error(self, msg: str):
        self._log(LogLevel.ERROR, msg)
