"""Run-dir metrics and config capture (counterpart of
``mpqe_tpu/train/metrics.py``): a JSON-lines stream of records, each with
a wall-clock timestamp, and the config written once into the run dir, in
the reference's formats.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict


def _jsonable(x: Any) -> Any:
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        try:
            return x.item()
        except Exception:
            pass
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)


class MetricsWriter:
    """Append-only JSONL metrics stream under ``run_dir/metrics.jsonl``."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, record: Dict[str, Any]) -> None:
        rec = dict(record)
        rec.setdefault("ts", time.time())
        self._f.write(json.dumps(_jsonable(rec)) + "\n")
        self._f.flush()

    def write_config(self, config: Any, name: str = "config.json") -> None:
        with open(os.path.join(self.run_dir, name), "w") as f:
            json.dump(_jsonable(config), f, indent=2)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
