"""Log-level parsing for argparse flags.

The port's copy of ``tpu_mednet/utils/misc.py`` (reference
``midasmednet/utils/misc.py:10-18``, whose ``_log_level_string_to_int``
never returned; this one does).
"""

from __future__ import annotations

import argparse
import logging

LOG_LEVEL_STRINGS = ["CRITICAL", "ERROR", "WARNING", "INFO", "DEBUG"]


def log_level_string_to_int(log_level_string: str) -> int:
    """``"info"`` -> ``logging.INFO``; an unknown name raises
    ``argparse.ArgumentTypeError`` (usable as an argparse ``type=``)."""
    value = log_level_string.upper()
    if value not in LOG_LEVEL_STRINGS:
        raise argparse.ArgumentTypeError(
            f"invalid choice: {log_level_string} (choose from {LOG_LEVEL_STRINGS})"
        )
    level = getattr(logging, value)
    if not isinstance(level, int):
        raise argparse.ArgumentTypeError(f"logging.{value} is not a level")
    return level


# reference-compatible aliases
_LOG_LEVEL_STRINGS = LOG_LEVEL_STRINGS
_log_level_string_to_int = log_level_string_to_int
