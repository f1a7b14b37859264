"""JSONL metrics logging (a sink file and stdout).

The port's own copy of ``deepctr_tpu/utils/logging.py::MetricsLogger``:
that module imports no jax, but importing it runs ``deepctr_tpu/utils``'s
package init, which does.
"""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None

    def log(self, record: dict) -> None:
        line = json.dumps({"ts": time.time(), **record}, default=float)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stdout, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
