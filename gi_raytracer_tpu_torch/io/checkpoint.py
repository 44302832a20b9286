"""Render checkpointing (a copy of ``gi_raytracer_tpu.io.checkpoint``).

The reference has no checkpointing — only incremental GUI repaint
(reference viewer.h:18-21).  Here the accumulation state (mean image,
variance, sample counters, wave index) round-trips through npz so long
renders survive preemption and can resume deterministically (the sampler is
counter-based, so wave w is reproducible at any time).

Writes are atomic (temp file + os.replace) so a crash mid-write — the exact
scenario checkpointing exists for — can never leave a truncated file behind.
Checkpoints carry a metadata record (resolution, seed, sampling config,
scene identity) that `load_checkpoint` validates so a resume can't silently
blend two incompatible sample streams.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

_META_KEY = "__meta__"


def save_checkpoint(path: str, meta: dict | None = None, **arrays) -> None:
    """Atomically write ``arrays`` (+ optional JSON-able ``meta``) to npz."""
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    if meta is not None:
        payload[_META_KEY] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str, expect_meta: dict | None = None) -> dict:
    """Load a checkpoint; verify its metadata against ``expect_meta``.

    Raises ValueError with a clear message on any mismatch (resolution,
    seed, sampling config, scene) instead of an opaque broadcast error deep
    inside the render — or worse, a silent blend of incompatible sample
    streams.
    """
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    meta = None
    if _META_KEY in out:
        meta = json.loads(bytes(out.pop(_META_KEY)).decode())
    if expect_meta is not None and meta is not None:
        bad = {k: (meta.get(k), v) for k, v in expect_meta.items()
               if meta.get(k) != v}
        if bad:
            detail = ", ".join(f"{k}: checkpoint={a!r} run={b!r}"
                               for k, (a, b) in bad.items())
            raise ValueError(
                f"checkpoint {path} is incompatible with this run ({detail});"
                " delete it or rerun with matching settings")
    out["meta"] = meta
    return out
