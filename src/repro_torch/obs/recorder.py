"""Flight recorder: bounded ring buffer of span/metric events + JSONL
export, and `torch.profiler` start/stop so device traces can be aligned
with host spans (`ServeEngine(profile=...)`).

A copy of ``repro/obs/recorder.py`` (the port imports nothing of the
reference), whose device profile is ``torch.profiler`` with CPU and, on
a CUDA engine, CUDA activities in place of ``jax.profiler``.  A profiler
that fails to start or stop raises: it is not warned about and skipped.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, List

SCHEMA_VERSION = 1


class FlightRecorder:
    """Keeps the most recent `capacity` events; older ones fall off the
    front (``dropped`` counts them) so a long replay can't OOM."""

    def __init__(self, capacity: int = 131072):
        self.capacity = int(capacity)
        self._buf = deque(maxlen=self.capacity)
        self.total = 0

    def record(self, event: Dict):
        self._buf.append(event)
        self.total += 1

    def record_metrics(self, snapshot: Dict, t: float):
        self.record({"kind": "metrics", "t": t, "data": snapshot})

    @property
    def dropped(self) -> int:
        return max(0, self.total - len(self._buf))

    def __len__(self):
        return len(self._buf)

    def events(self) -> List[Dict]:
        return list(self._buf)

    def span_count(self) -> int:
        return sum(1 for e in self._buf if e.get("kind") == "span")

    def clear(self):
        self._buf.clear()
        self.total = 0

    def export_jsonl(self, path: str) -> str:
        """One meta line, then one JSON object per event."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            meta = {"kind": "meta", "version": SCHEMA_VERSION,
                    "events": len(self._buf), "total": self.total,
                    "dropped": self.dropped, "clock": "perf_counter"}
            f.write(json.dumps(meta) + "\n")
            for ev in self._buf:
                f.write(json.dumps(ev) + "\n")
        return path


# ------------------------------------------------------ device profiler

# the live torch.profiler session (one per process, as jax.profiler's)
_PROFILER = None


def start_device_profile(logdir: str, device="cuda") -> bool:
    """Begin a torch.profiler trace that lands in `logdir` as a Chrome
    trace (``*.pt.trace.json``) at `stop_device_profile`; CUDA activity
    is recorded when `device` is a CUDA device.  False (a no-op) when a
    profile is already live."""
    global _PROFILER
    if _PROFILER is not None:
        return False
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(logdir))
    prof.start()
    _PROFILER = prof
    return True


def stop_device_profile() -> bool:
    """End the live profile and write its trace; False when none is
    live."""
    global _PROFILER
    if _PROFILER is None:
        return False
    prof, _PROFILER = _PROFILER, None
    prof.stop()
    return True
