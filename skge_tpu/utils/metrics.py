"""Structured per-epoch/step metrics — SURVEY.md §5 observability mapping.

The reference exposes only `trainer.loss` / `trainer.nviolations` to
callbacks plus stdlib logging in the harness. Here every epoch emits a
structured record (loss, violations, wall time, triples/s) to an in-memory
history and optionally a JSONL file; `jax.profiler` trace hooks are exposed
for on-device profiling.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import jax


@dataclass
class MetricsLogger:
    jsonl_path: Optional[str] = None
    history: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, record: Dict[str, Any]) -> None:
        record = dict(record, time=time.time())
        self.history.append(record)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def last(self) -> Dict[str, Any]:
        return self.history[-1] if self.history else {}


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(logdir):
        yield


class StepTimer:
    """Wall-clock timer mirroring `epoch_start` (skge/base.py ~160)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def reset(self) -> float:
        dt = self.elapsed()
        self.t0 = time.perf_counter()
        return dt
