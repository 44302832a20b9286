"""What one run records, for the metric readers and the checks."""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class Run:
    cell: object                 # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    setup_s: float = 0.0
    jobs: list = dataclasses.field(default_factory=list)   # seconds each
    units: list = dataclasses.field(default_factory=list)  # work each
    window_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)  # name -> [s]
    counts: dict = dataclasses.field(default_factory=dict)
    dtrace: object = None        # devtrace.DeviceTrace of the window
    work: dict = dataclasses.field(default_factory=dict)   # yardstick
    checks: list = dataclasses.field(default_factory=list)  # (name, v, lim)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    """Host seconds of a block, synchronised on both ends, appended to
    ``run.spans[name]``."""

    def __init__(self, run, name):
        self.run, self.name = run, name

    def __enter__(self):
        self.run.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.run.sync()
            self.run.spans.setdefault(self.name, []).append(
                time.perf_counter() - self.t0)
        return False
