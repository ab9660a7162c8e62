"""Timestamped logging; the port of `log` from `sagnn_tpu/utils/logger.py`
(ref: Utils/TimeLogger.py:19-38).

Wall-clock timestamped lines, and a carriage-return `oneline` mode for
progress lines. The JAX package's in-memory line buffer has no reader in
the port and is left out.
"""

from __future__ import annotations

import datetime
import sys

_last_oneline = False


def log(msg: str, oneline: bool = False) -> None:
    """Print `<time>: msg`; ref Utils/TimeLogger.py:19-38."""
    global _last_oneline
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    tem = f"{stamp}: {msg}"
    if oneline:
        sys.stdout.write("\r" + tem)
        sys.stdout.flush()
        _last_oneline = True
    else:
        if _last_oneline:
            sys.stdout.write("\n")
            _last_oneline = False
        print(tem, flush=True)
