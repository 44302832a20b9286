"""The device trace of a window: ``torch.profiler`` with the CUDA activity
alone (a long window of many small operations stays cheap to trace), and
its reduction to busy time, time and launches by kernel name, and idle
gaps.

The reduction is the arithmetic of ``chip_smoke.profile`` at commit
e5c621cb1248e04fcb8b4b38f842b5dd40c8e8a0: device events summed from the
profiler's raw kineto records (fast, where ``key_averages`` takes minutes
over hundreds of thousands of events), user annotations left out, a
kernel named without its namespace qualifier and argument list.  Busy
time is the union of the events' intervals, which is their sum on one
stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float                 # union of the device events' intervals
    kernels: dict                 # name -> [seconds, launches]
    gaps: dict                    # "after <name>" -> idle seconds
    n_events: int

    def time(self, patterns) -> float:
        """Device seconds of the kernels whose name holds a pattern."""
        return sum(v[0] for k, v in self.kernels.items()
                   if any(p in k for p in patterns))

    def launches(self, patterns=None) -> int:
        return sum(v[1] for k, v in self.kernels.items()
                   if patterns is None or any(p in k for p in patterns))

    def top(self, n: int = 10) -> list:
        return [[k, v[0]] for k, v in sorted(
            self.kernels.items(), key=lambda kv: -kv[1][0])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        return [[k, v] for k, v in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:n]]


def name_of(raw: str) -> str:
    return raw.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ").strip()


def start():
    """A running profiler of the device alone."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def reduce(records) -> DeviceTrace:
    """``records``: (name, start_ns, duration_ns) of device events."""
    ids, names, starts, durs = {}, [], [], []
    for name, t0, dur in records:
        i = ids.get(name)
        if i is None:
            i = ids[name] = len(ids)
        names.append(i)
        starts.append(t0)
        durs.append(dur)
    return _reduce(list(ids), np.asarray(names, np.int64),
                   np.asarray(starts, np.int64), np.asarray(durs, np.int64))


def _reduce(labels, name_id, start, dur) -> DeviceTrace:
    n = len(labels)
    if start.size == 0:
        return DeviceTrace(0.0, {}, {}, 0)
    secs = np.bincount(name_id, weights=dur, minlength=n) / 1e9
    count = np.bincount(name_id, minlength=n)
    kernels = {labels[i]: [float(secs[i]), int(count[i])] for i in range(n)}
    order = np.argsort(start, kind="stable")
    s, e, nid = start[order], start[order] + dur[order], name_id[order]
    run_end = np.maximum.accumulate(e)
    # the event that holds the running end: the latest one to reach it
    idx = np.arange(e.size)
    holder = np.maximum.accumulate(np.where(e == run_end, idx, 0))
    gap = s[1:] - run_end[:-1]
    has = gap > 0
    busy = (run_end[-1] - s[0]) - gap[has].sum()
    after = nid[holder[:-1]][has]
    g = np.bincount(after, weights=gap[has], minlength=n) / 1e9
    gaps = {f"after {labels[i]}": float(g[i]) for i in range(n) if g[i] > 0}
    return DeviceTrace(float(busy) / 1e9, kernels, gaps, int(e.size))


def stop(prof) -> DeviceTrace:
    """Stop ``prof`` (after the window's closing synchronise) and reduce
    its device events.  Names are cleaned once per raw name."""
    import sys
    import time

    import torch
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    t1 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    ids, labels, nid, start, dur = {}, [], [], [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or ev.is_user_annotation():
            continue
        raw = ev.name()
        i = ids.get(raw)
        if i is None:
            i = ids[raw] = len(ids)
            labels.append(name_of(raw))
        nid.append(i)
        start.append(ev.start_ns())
        dur.append(ev.duration_ns())
    # raw names that clean to one name are one kernel
    clean = {}
    remap = np.asarray([clean.setdefault(lab, len(clean)) for lab in labels]
                       or [0], np.int64)
    out = _reduce(list(clean), remap[np.asarray(nid, np.int64)],
                  np.asarray(start, np.int64), np.asarray(dur, np.int64))
    print(f"gibench: device trace of {out.n_events} events: stop "
          f"{t1 - t0:.1f} s, reduction {time.perf_counter() - t1:.1f} s",
          file=sys.stderr)
    return out
