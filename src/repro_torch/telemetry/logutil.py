"""Logging setup shared by the port's CLIs and self-tests.

The port's own copy of the JAX package's ``repro.telemetry.logutil``.  One
convention everywhere: human-readable progress goes through ``logging``
(so ``--quiet`` / ``--verbose`` work alike), while the machine-readable
``RESULT_JSON:`` line stays a bare ``print()``, a wire format that stays
byte-identical at any verbosity.
"""

from __future__ import annotations

import argparse
import logging
import sys


def add_verbosity_flags(ap: argparse.ArgumentParser) -> None:
    """Attach the standard ``--quiet`` / ``--verbose`` pair."""
    g = ap.add_mutually_exclusive_group()
    g.add_argument(
        "-q", "--quiet", action="store_true",
        help="suppress progress output (warnings and RESULT_JSON lines only)",
    )
    g.add_argument("-v", "--verbose", action="store_true", help="debug-level progress output")


def setup_logging(
    quiet: bool = False, verbose: bool = False, name: str = "repro_torch"
) -> logging.Logger:
    """Configure and return the CLI logger (message-only format, stdout)."""
    level = logging.WARNING if quiet else logging.DEBUG if verbose else logging.INFO
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    else:
        # a CLI run in process (``main(argv)``) writes to the sys.stdout of
        # this call, which a caller may have replaced (and closed) since the
        # last one: assigned, not setStream(), which flushes the old stream
        for handler in logger.handlers:
            if isinstance(handler, logging.StreamHandler):
                handler.stream = sys.stdout
    logger.propagate = False
    return logger
