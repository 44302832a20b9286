"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (scene, photon map, renderer or step, one warm-up job) is timed
as ``setup_s``.  The window then runs the cell's job in a closed loop,
one caller, the next job once the last has finished and the card has
synchronised, until ``--seconds`` have passed; it ends with the job that
is running then.  With ``--trace 1`` the window runs under
``torch.profiler`` (the device alone) and the line carries the per-layer
metrics instead of the end-to-end ones, with the device's busy seconds
and a breakdown.  After the window the program's answers are judged
against the plain reference (``ref/``): the last lines on standard error
and the ``checks`` key, last in the line, give each number with its
limit.

``--control 1`` runs no window and no program: it judges the reference
computed in bfloat16 (``ref/precision.py``) as if it were the program's
answer, with the cell's own comparison, and prints the numbers (the
readings that set the upper end of each limit); ``--fault half`` judges
a kind's planted fault instead (the step over half of its lanes).

The run prints no result and exits 2 without a card (or with fewer than
the cell asks for), when a plain version ran inside the window, or when a
module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from gibench.core import devtrace, guards, spec  # noqa: E402
from gibench.core.runctx import Run  # noqa: E402


THREADS = 2


def parse(argv):
    p = argparse.ArgumentParser(prog="gibench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None,
                   help="with --control 1: judge the reference with this "
                        "fault planted instead of the bfloat16 control")
    return p.parse_args(argv)


def _metrics(run, entries) -> dict:
    out = {}
    for m in entries:
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _checks(run, got: dict) -> tuple:
    """({name: {"value", "limit"}}, correct): every number compared must
    lie at or below its limit."""
    lim = run.cell.limits
    missing = sorted(set(lim) - set(got))
    if missing:
        raise RuntimeError(f"no reading of {missing}")
    checks = {k: {"value": got[k], "limit": lim[k]} for k in sorted(got)
              if k in lim}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def _judge(run, kind, ans) -> dict:
    """The reference's comparison of answers ``ans``: {name: value}."""
    import torch
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        ref = kind.reference(run, ans)
    return kind.compare(ans, ref)


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             data_dirs=(spec.HERE,)) -> dict:
    """One run of cell ``name``; returns the result line's object.  Only
    the tests pass ``device="cpu"``: it skips the look for a card and the
    plain-version guard, and runs the program's plain versions."""
    import torch
    cell = spec.cell(bench, name, data_dirs)
    on_card = device == "cuda"
    if on_card:
        guards.require_card(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        # one process with few threads: the host paces every cell, and
        # with torch's own count (8 on an 8-core host) frames ran about
        # 10% slower and spread no less (PERF.md §2)
        torch.set_num_threads(THREADS)
    from gi_raytracer_tpu_torch.ops import _cuda
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              device=torch.device(device, 0) if on_card
              else torch.device(device))
    kind = spec.module("kinds", cell.traffic["kind"])

    t0 = time.perf_counter()
    state = kind.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t0

    plain0 = dict(_cuda.plain_calls)
    prof = devtrace.start() if trace and on_card else None
    w0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        run.units.append(kind.job(state, i))
        run.sync()
        b = time.perf_counter()
        run.jobs.append(b - a)
        i += 1
        if b - w0 >= seconds:
            break
    run.window_s = time.perf_counter() - w0
    if prof is not None:
        run.dtrace = devtrace.stop(prof)
    if on_card:
        guards.require_no_plain(plain0, dict(_cuda.plain_calls))
        peak = torch.cuda.max_memory_allocated(run.device)
        kind_name = torch.cuda.get_device_name(run.device)
    else:
        peak, kind_name = 0, "cpu"

    ans = kind.after_window(state, run)
    del state
    t1 = time.perf_counter()
    got = _judge(run, kind, ans)
    print(f"gibench: {name} seed {seed}: setup {run.setup_s:.3f} s, window "
          f"{run.window_s:.3f} s ({len(run.jobs)} jobs), reference "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    checks, correct = _checks(run, got)
    if on_card:
        guards.require_no_jax()
    line = {"correct": correct, "attempted": len(run.jobs), "failed": 0,
            "metrics": _metrics(run, cell.per_layer if trace
                                else cell.end_to_end),
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": kind_name, "count": cell.chips,
                       "memory_peak_bytes": int(peak)}}
    if trace and run.dtrace is not None:
        line["device"].update(busy_s=run.dtrace.busy_s,
                              window_s=run.window_s)
        line["breakdown"] = {"device_ops": run.dtrace.top(10),
                             "idle_gaps": run.dtrace.top_gaps(10)}
    line["checks"] = checks
    return line


def run_control(bench: dict, name: str, seed: int, device: str = "cuda",
                data_dirs=(spec.HERE,), fault=None) -> dict:
    """The control's readings of cell ``name`` on ``seed`` (or, with
    ``fault``, those of the reference with that fault planted)."""
    import torch
    cell = spec.cell(bench, name, data_dirs)
    if device == "cuda":
        guards.require_card(cell.chips)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell=cell, seed=seed, seconds=0.0, trace=False,
              device=torch.device(device, 0) if device == "cuda"
              else torch.device(device))
    kind = spec.module("kinds", cell.traffic["kind"])
    t0 = time.perf_counter()
    with torch.no_grad():
        ans = kind.control(run) if fault is None else kind.fault(run, fault)
    got = _judge(run, kind, ans)
    checks, correct = _checks(run, got)
    return {"control": fault or True, "correct": correct, "seed": seed,
            "seconds": time.perf_counter() - t0, "checks": checks}


def main(argv=None) -> int:
    args = parse(argv)
    bench = spec.load_benchmark()
    try:
        if args.control:
            line = run_control(bench, args.workload, args.seed,
                               fault=args.fault)
        else:
            line = run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace))
    except guards.Refused as e:
        print(f"gibench: refused: {e}", file=sys.stderr)
        return 2
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
