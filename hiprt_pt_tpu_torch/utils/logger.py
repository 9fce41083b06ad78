"""Thread-safe severity-colored logger with named updatable progress lines,
a copy of ``hiprt_pt_tpu.utils.logger`` (reference: ImGuiLogger,
src/UI/ImGui/ImGuiLogger.h:26-99: a global logger, severity colors, and
named lines updated in place as progress bars)."""

from __future__ import annotations

import sys
import threading
import time

_COLORS = {
    "DEBUG": "\033[90m",
    "INFO": "\033[0m",
    "WARN": "\033[93m",
    "ERROR": "\033[91m",
}
_RESET = "\033[0m"


class Logger:
    def __init__(self, stream=None):
        self._lock = threading.Lock()
        self._stream = stream or sys.stderr
        self._named: dict[str, str] = {}

    def _emit(self, level: str, msg: str):
        with self._lock:
            color = _COLORS.get(level, "")
            ts = time.strftime("%H:%M:%S")
            self._stream.write(f"{color}[{ts}][{level}] {msg}{_RESET}\n")
            self._stream.flush()

    def debug(self, msg: str):
        self._emit("DEBUG", msg)

    def info(self, msg: str):
        self._emit("INFO", msg)

    def warn(self, msg: str):
        self._emit("WARN", msg)

    def error(self, msg: str):
        self._emit("ERROR", msg)

    def update_line(self, name: str, msg: str):
        """Named updatable line (progress-bar style, reference: ImGuiLogger
        named lines used by the compile sweep)."""
        with self._lock:
            self._named[name] = msg
            self._stream.write(f"\r{msg}\033[K")
            self._stream.flush()

    def end_line(self, name: str):
        with self._lock:
            self._named.pop(name, None)
            self._stream.write("\n")
            self._stream.flush()


_global_logger = Logger()


def get_logger() -> Logger:
    return _global_logger
