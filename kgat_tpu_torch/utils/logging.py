"""Structured logging: JSONL events + a human-readable stderr line.

Port of ``kgat_tpu/utils/logging.py``: one JSON line per event (``start``,
``epoch``, ``eval``, ``done``, ...) with the same names and fields.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class RunLogger:
    """Appends ``{"event": ..., "t": seconds since start, **fields}`` to
    ``<log_dir>/<run_name>.jsonl`` and prints the fields to stderr unless
    ``quiet``. The file is truncated when the logger is made, unless
    ``resume``: a resumed run appends, so its event log stays one file."""

    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 quiet: bool = False, resume: bool = False):
        self.t0 = time.time()
        self.quiet = quiet
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{run_name}.jsonl")
            if not resume:
                with open(self.path, "w"):
                    pass

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"event": event, "t": round(time.time() - self.t0, 3), **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if not self.quiet:
            kv = " ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items())
            print(f"[{rec['t']:9.2f}s] {event}: {kv}", file=sys.stderr)
        return rec
