"""Log formatting with millisecond UTC timestamps.

A copy of `setup_logging` from `hotstuff_tpu/utils/logging.py`: the same
`-v` levels and the same line format, which the benchmark harness parses:

    [2026-07-29T12:34:56.789Z INFO hotstuff.crypto] Crypto sidecar (torch) successfully booted on ...
"""

from __future__ import annotations

import logging
import sys
import time


class UtcMsFormatter(logging.Formatter):
    converter = time.gmtime

    def formatTime(self, record, datefmt=None):
        ct = self.converter(record.created)
        return f"{time.strftime('%Y-%m-%dT%H:%M:%S', ct)}.{int(record.msecs):03d}Z"


def level_of(verbosity: int) -> int:
    """-v count -> level: 0=ERROR, 1=WARNING, 2=INFO, 3+=DEBUG."""
    return [logging.ERROR, logging.WARNING, logging.INFO, logging.DEBUG][min(verbosity, 3)]


def setup_logging(verbosity: int = 2, stream=None) -> None:
    """Install one stderr (or `stream`) handler on the root logger at the
    level of `verbosity`."""
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(UtcMsFormatter("[%(asctime)s %(levelname)s %(name)s] %(message)s"))
    root = logging.getLogger()
    root.handlers.clear()
    root.addHandler(handler)
    root.setLevel(level_of(verbosity))
