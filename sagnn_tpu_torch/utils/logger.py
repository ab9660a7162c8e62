"""Timestamped logging; the port of `log` from `sagnn_tpu/utils/logger.py`
(ref: Utils/TimeLogger.py:19-38).

Wall-clock timestamped lines, a carriage-return `oneline` mode for
progress lines, and the named timers `marktime` / `spent_time`. The JAX
package's in-memory line buffer has no reader in the port and is left out.
"""

from __future__ import annotations

import datetime
import sys
import time

_last_oneline = False
_timemark: dict = {}


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


def marktime(marker: str) -> None:
    """Record a named start time; ref Utils/TimeLogger.py:9-11."""
    _timemark[marker] = time.time()


def spent_time(marker: str) -> float:
    """Seconds since `marktime(marker)`; ref Utils/TimeLogger.py:13-15.
    KeyError for a marker never marked."""
    return time.time() - _timemark[marker]
