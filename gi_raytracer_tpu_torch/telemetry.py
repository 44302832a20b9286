"""The program's spans and counters, recorded while a torch profiler runs.

A span is a block of host time at a layer boundary (a frame, a wave and
its parts, a trace's analytic passes, a fog march, a photon pass and
its retry rounds, the photon grid, a K3 call, a train step, the kNN
VJP); a sync
is a span named ``"sync"`` around one host sync, its ``site`` attribute
naming the call site: one operation that waits for the card when its
tensors are there (a read of a result, a ``nonzero``, a copy of host
numbers to the card; on CPU tensors the span marks the same operation,
which waits for nothing). Nothing is recorded unless a torch profiler is
enabled (``torch.profiler.profile`` of any activity), or a span that was
recorded is still open (a child then records too, on whichever thread
runs it: autograd runs a CUDA backward on a thread of its own). There is
no other switch: a run that profiles nothing records nothing, and a span
then costs one check; :func:`muted` turns recording off for a block.

Spans never enter the profiler's event stream (no ``record_function``, no
NVTX), so a device trace is the same with and without them.  Their
stamps come from ``time.time_ns``, the clock ``torch.profiler`` stamps
its events with (c10's ``getTime``, ``CLOCK_REALTIME`` on Linux), so an
idle gap between the profiler's device events can be put down to the
span open on the host when it began (:func:`idle_by_span`).

Each record holds its name, start and end in ns, its id, its parent's id
(None for a root) and its root's id (the frame, the pass, the step: the
spans of one job share it), and the attributes it was given, host-known
ints only but the ``route`` of a ``photons.round``, ``wave.trace`` or
``wave.inputs`` or ``fog.march`` span (the decision of ``routes`` that
chose its code: ``photon_round``, ``wave``, ``wave_inputs``,
``fog_march``) and the ``graph`` of a
``wave.trace`` span (``"replay"`` or ``"eager"``, ``routes.wave_graph``:
whether the wave was one CUDA graph's replay) and the ``use`` of a
``fog.march`` span (``"scatter"`` or ``"shadow"``).  A ``wave`` span's
``blocks`` and ``lanes`` count the 16x16 blocks and the lanes it traced; a ``trace.analytic`` span's ``lanes`` and
``prims`` the rays and the spheres and cones its passes test; a
``fog.march`` span's ``lanes``, ``blocks`` and ``lane_steps`` the lanes
entering the march, its blocks of steps and their lanes times steps (on
the kernel's route counted on the card, :func:`counts_ptr`).
Records are kept in memory: :func:`records` and :func:`reset`.

K3's tier counts: while recording, the kNN kernel adds each launch's
queued and taken counts to two 64-bit totals in pinned host memory
(:func:`k3_totals_ptr`), with no launch and no sync of its own;
:func:`k3_counts` reads them once the card has synchronised.  A span's
attributes can come from the card the same way (:func:`counts_ptr`: the
fog march kernel's ``lanes``, ``lane_steps`` and ``blocks``): a kernel
adds them to pinned host memory, and :func:`records` reads them into the
span, so read the records once the card has synchronised.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns
NONE = "(none)"      # idle_by_span's key for gaps no span covers


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    root: int
    attrs: dict

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Recorder:
    """The process's records: closed spans, the open ones (innermost
    last), the next id, and K3's pinned totals once a call needed them."""

    def __init__(self):
        self.closed: list = []
        self.open: list = []
        self.next_id = 0
        self.k3 = None
        self.muted = 0
        # counts_ptr's pinned int64 slabs (the newest last), the slots
        # taken in the newest, and the spans waiting for their counts:
        # (span, keys, slab, first slot)
        self.slabs: list = []
        self.used = 0
        self.pending: list = []


_rec = _Recorder()


class _Recording:
    __slots__ = ("name", "attrs", "span")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        up = _rec.open[-1] if _rec.open else None
        i = _rec.next_id
        _rec.next_id += 1
        self.span = Span(self.name, _now(), 0, i,
                         None if up is None else up.id,
                         i if up is None else up.root, self.attrs)
        _rec.open.append(self.span)
        return self.span

    def __exit__(self, *exc):
        sp = self.span
        sp.end_ns = _now()
        if sp in _rec.open:     # not after a reset()
            _rec.open.remove(sp)
        _rec.closed.append(sp)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager that records the block as span ``name`` with
    ``attrs`` while recording (it yields the ``Span``), and does nothing
    otherwise (it yields None)."""
    if not _rec.muted and (_rec.open or _profiling()):
        return _Recording(name, attrs)
    return _OFF


@contextlib.contextmanager
def muted():
    """Record nothing inside the block, under a profiler or not: the code
    there issues no work (a CUDA graph's capture), so a span would time
    nothing."""
    _rec.muted += 1
    try:
        yield
    finally:
        _rec.muted -= 1


def sync(site: str):
    """``span("sync", site=site)``: put it around each host sync."""
    return span("sync", site=site)


SLAB = 1 << 16      # int64 slots a pinned slab of counts_ptr holds


def counts_ptr(sp, *keys):
    """The address of ``len(keys)`` int64 zeros in pinned host memory that
    a kernel adds its counts to while recording, for the span ``sp``'s
    attributes ``keys`` (:func:`records` reads them into it); None where
    ``sp`` is None (not recording: the kernel counts nothing)."""
    if sp is None:
        return None
    n = len(keys)
    if not _rec.slabs or _rec.used + n > _rec.slabs[-1].numel():
        _rec.slabs.append(torch.zeros(SLAB, dtype=torch.int64,
                                      pin_memory=torch.cuda.is_available()))
        _rec.used = 0
    slab, first = _rec.slabs[-1], _rec.used
    _rec.used += n
    _rec.pending.append((sp, keys, slab, first))
    return slab.data_ptr() + 8 * first


def records() -> list:
    """The closed spans, in the order they opened; a span's counts from
    the card (:func:`counts_ptr`) as they stand in pinned memory."""
    views = {id(slab): slab.numpy() for slab in _rec.slabs}
    for sp, keys, slab, first in _rec.pending:
        sp.attrs.update(zip(keys, views[id(slab)][first:first + len(keys)]
                            .tolist()))
    return sorted(_rec.closed, key=lambda sp: sp.id)


def reset():
    """Forget every record and zero K3's totals and the spans' counts."""
    _rec.closed.clear()
    _rec.open.clear()
    _rec.next_id = 0
    if _rec.k3 is not None:
        _rec.k3.zero_()
    _rec.pending.clear()
    del _rec.slabs[:-1]
    if _rec.slabs:
        _rec.slabs[0].zero_()
    _rec.used = 0


def k3_totals_ptr() -> int:
    """The address of K3's two int64 totals (queued, taken): pinned host
    memory the card writes through, allocated at the first call."""
    if _rec.k3 is None:
        _rec.k3 = torch.zeros(2, dtype=torch.int64, pin_memory=True)
    return _rec.k3.data_ptr()


def k3_counts() -> tuple:
    """(queries queued for K3's focal tier, queue entries its blocks
    took), summed over the K3 launches made while recording since the
    last :func:`reset`; read after the card has synchronised."""
    if _rec.k3 is None:
        return 0, 0
    return tuple(int(x) for x in _rec.k3.tolist())


def self_ns(spans) -> dict:
    """{id: self ns}: a span's duration less the part of its interval
    that its children cover."""
    kids: dict = {}
    for sp in spans:
        if sp.parent is not None:
            kids.setdefault(sp.parent, []).append(sp)
    out = {}
    for sp in spans:
        covered, end = 0, sp.start_ns
        for c in sorted(kids.get(sp.id, ()), key=lambda c: c.start_ns):
            a, b = max(c.start_ns, end), min(c.end_ns, sp.end_ns)
            if b > a:
                covered += b - a
                end = b
        out[sp.id] = sp.ns - covered
    return out


def label(sp) -> str:
    """A span's row in the tables: its name, and its ``route`` and
    ``graph`` in brackets where it has them (``photons.round[k2]``,
    ``wave.trace[staged, replay]``)."""
    tags = [sp.attrs[k] for k in ("route", "graph") if k in sp.attrs]
    return f"{sp.name}[{', '.join(tags)}]" if tags else sp.name


def summary(spans) -> dict:
    """{label: (count, total ns, self ns)} over ``spans``."""
    own = self_ns(spans)
    out: dict = {}
    for sp in spans:
        n, tot, slf = out.get(label(sp), (0, 0, 0))
        out[label(sp)] = (n + 1, tot + sp.ns, slf + own[sp.id])
    return out


def device_events(prof) -> list:
    """(start_ns, duration_ns) of a finished ``torch.profiler.profile``'s
    device events (kernels, copies, fills; not user annotations)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.start_ns(), ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda and not ev.is_user_annotation()]


def chrome_events(spans, base_ns: int, pid: int) -> list:
    """``spans`` as Chrome trace events (microseconds from ``base_ns``,
    the ``baseTimeNanoseconds`` of the profiler's trace) on a row of
    their own in process ``pid``: added to the profiler's trace, they
    line up with its events in Perfetto or ``chrome://tracing``."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans"}}]
    for sp in spans:
        out.append({"ph": "X", "cat": "program_span", "name": sp.name,
                    "pid": pid, "tid": 0, "ts": (sp.start_ns - base_ns) / 1e3,
                    "dur": sp.ns / 1e3,
                    "args": dict(sp.attrs, id=sp.id, parent=sp.parent,
                                 root=sp.root)})
    return out


def report(spans, events) -> list:
    """Lines of two tables: each span label's (:func:`label`) count,
    total and self seconds; and the device's idle seconds between
    ``events`` by the span open on the host when each gap began, with
    their share of all idle time."""
    lines = ["span                 count    total_s     self_s"]
    for name, (n, tot, own) in sorted(summary(spans).items(),
                                      key=lambda kv: -kv[1][2]):
        lines.append(f"{name:<20} {n:5d} {tot / 1e9:10.4f} {own / 1e9:10.4f}")
    idle = idle_by_span(events, spans)
    if not idle:
        lines.append("device idle by span: no device events")
        return lines
    total = sum(idle.values())
    lines.append("device idle by span    idle_s   share")
    for name, secs in sorted(idle.items(), key=lambda kv: -kv[1]):
        lines.append(f"{name:<20} {secs:8.4f} {100 * secs / total:6.1f}%")
    return lines


def idle_by_span(device_events, spans=None) -> dict:
    """{span name: idle seconds}: each idle gap between the device events
    ((start_ns, duration_ns) pairs; a gap is where the union of their
    intervals is broken, as ``gibench/core/devtrace.py`` finds it), put
    down to the innermost span open on the host when the gap began, and
    under ``NONE`` where no span was open.  ``spans``: default
    :func:`records`."""
    ev = np.asarray(list(device_events), np.int64).reshape(-1, 2)
    if ev.shape[0] < 2:
        return {}
    order = np.argsort(ev[:, 0], kind="stable")
    s, e = ev[order, 0], ev[order, 0] + ev[order, 1]
    run_end = np.maximum.accumulate(e)
    gap = s[1:] - run_end[:-1]
    has = gap > 0
    began, gap = run_end[:-1][has], gap[has]
    spans = records() if spans is None else list(spans)
    # the innermost open span on each stretch between span boundaries:
    # ends before starts at one instant (a span is open on [start, end)),
    # an outer span's start before its children's
    marks = sorted([(sp.end_ns, 0, sp.id, sp) for sp in spans]
                   + [(sp.start_ns, 1, sp.id, sp) for sp in spans],
                   key=lambda m: m[:3])
    names = [NONE]
    seg_t, seg_name, open_ = [], [], []
    for j, (t, kind, _, sp) in enumerate(marks):
        if kind:
            open_.append(sp)
        else:
            open_.remove(sp)
        if j + 1 < len(marks) and marks[j + 1][0] == t:
            continue
        name = label(open_[-1]) if open_ else NONE
        if name not in names:
            names.append(name)
        seg_t.append(t)
        seg_name.append(names.index(name))
    at = np.searchsorted(np.asarray(seg_t, np.int64), began,
                         side="right") - 1
    which = np.where(at >= 0, np.asarray(seg_name + [0], np.int64)[at], 0)
    secs = np.bincount(which, weights=gap, minlength=len(names)) / 1e9
    return {n: float(secs[i]) for i, n in enumerate(names) if secs[i] > 0}
