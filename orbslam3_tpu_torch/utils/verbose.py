"""Log-level gated printing (reference Verbose singleton,
include/System.h:47-73: VERBOSITY_QUIET/NORMAL/VERBOSE/VERY_VERBOSE/DEBUG,
set to QUIET at startup in src/System.cc:179).

Module-level state mirrors the reference's static class: one process-wide
threshold, messages print only at or below it.
"""
from __future__ import annotations

QUIET = 0
NORMAL = 1
VERBOSE = 2
VERY_VERBOSE = 3
DEBUG = 4

_level = QUIET


def set_verbosity(level: int) -> None:
    """Reference Verbose::SetTh."""
    global _level
    _level = int(level)


def get_verbosity() -> int:
    return _level


def print_mess(msg: str, level: int = NORMAL) -> None:
    """Reference Verbose::PrintMess: print iff level <= current threshold."""
    if level <= _level:
        print(msg, flush=True)
