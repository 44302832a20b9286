"""The Cornell box in height fog: ``cornell.cornell_box(full=True)`` with
one ``heightFog`` volume added.

The upstream renders fog with its ``heightFog`` directive
(``sceneLoader.cpp:150-159``) and an ``ambient`` term (``:168-171``);
its ``render_atmosphere.png`` shows the Cornell box in fog, but the
parameters of that image were never recorded.  The defaults here are the
repository's reconstruction fitted to that image
(``scripts/validate_golden.py``: ``heightFog 4 3.4 0 16 8 8.4 1 1 1 .05
.5 2``): a box from y = -0.6 to past the ceiling, so every ray in the
upper room marches through fog.  The ambient term is the render's, not
the scene's, and the configuration states it.

Takes the builder class and the mesh module, as ``cornell_box`` does,
and returns the populated builder.
"""

from __future__ import annotations

from . import cornell

FOG_POS = (4.0, 3.4, 0.0)
FOG_SIZE = (16.0, 8.0, 8.4)
FOG_COLOR = (1.0, 1.0, 1.0)


def cornell_fog(builder, meshgen, pos=FOG_POS, size=FOG_SIZE,
                color=FOG_COLOR, density: float = 0.05,
                scatter: float = 0.5, noise_scale: int = 2, seed: int = 0):
    """The full Cornell box (2,198 triangles, one light) and a height-fog
    box at ``pos`` of ``size``, its noise grid drawn from ``seed``."""
    b = cornell.cornell_box(builder, meshgen, full=True)
    b.add_height_fog(tuple(pos), tuple(size), tuple(color), density,
                     scatter, noise_scale, seed=seed)
    return b
