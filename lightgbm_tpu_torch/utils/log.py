"""Leveled logger, the counterpart of the reference's static ``Log`` class
(include/LightGBM/utils/log.h). ``Log.fatal`` raises (the reference throws a
``std::runtime_error`` that the CLI main() catches)."""

from __future__ import annotations

import sys


class LightGBMError(RuntimeError):
    """Raised by Log.fatal — the counterpart of the reference's fatal throw."""


class Log:
    # Levels: fatal=-1, warning=0, info=1, debug=2 (reference log.h LogLevel)
    _level = 1

    @classmethod
    def reset_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def get_level(cls) -> int:
        return cls._level

    @classmethod
    def debug(cls, msg: str, *args) -> None:
        if cls._level >= 2:
            cls._write("Debug", msg, args)

    @classmethod
    def info(cls, msg: str, *args) -> None:
        if cls._level >= 1:
            cls._write("Info", msg, args)

    @classmethod
    def warning(cls, msg: str, *args) -> None:
        if cls._level >= 0:
            cls._write("Warning", msg, args)

    @classmethod
    def fatal(cls, msg: str, *args) -> None:
        text = (msg % args) if args else msg
        raise LightGBMError(text)

    @staticmethod
    def _write(level_str: str, msg: str, args) -> None:
        text = (msg % args) if args else msg
        sys.stdout.write(f"[LightGBM-TPU] [{level_str}] {text}\n")
        sys.stdout.flush()
