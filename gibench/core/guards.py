"""What every run refuses to measure.

* No card, or fewer cards than the cell asks for: the run fails before
  any work, and never falls back to the CPU.
* JAX in the process: ``jax``, ``jaxlib``, ``flax`` or the JAX package
  ``gi_raytracer_tpu`` in ``sys.modules``, compared by whole top-level
  names (the port's ``gi_raytracer_tpu_torch`` begins with the JAX
  package's name and is not one of them).
* A plain version on the timed path: the program's ``plain_calls``
  counter must not move over the window.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gi_raytracer_tpu")


class Refused(RuntimeError):
    """A run that must print no result."""


def require_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} present")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def require_no_jax():
    found = forbidden_modules()
    if found:
        raise Refused("modules of JAX or the JAX package are loaded: "
                      + ", ".join(found))


def require_no_plain(before: dict, after: dict):
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in after
             if after.get(k, 0) != before.get(k, 0)}
    if moved:
        raise Refused(f"plain versions ran inside the window: {moved}")
