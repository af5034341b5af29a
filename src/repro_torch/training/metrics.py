"""JSONL metrics logging for the serve CLI (the port's own copy of the
JAX package's ``training/metrics.py``): machine-readable run logs next
to the console output."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *, run_name: str = "",
                 echo: bool = False):
        self.path = Path(path) if path else None
        self.run_name = run_name
        self.echo = echo
        self._t0 = time.perf_counter()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        else:
            self._fh = None

    def log(self, kind: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": round(time.perf_counter() - self._t0, 4),
               "run": self.run_name, "kind": kind}
        for k, v in fields.items():
            rec[k] = float(v) if hasattr(v, "item") else v
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            print(rec)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
