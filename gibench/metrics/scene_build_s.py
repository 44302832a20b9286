"""scene_build_s: host seconds of the program's ``SceneBuilder.build``
in set-up (the SAH BVH, the triangle tables, the copy to the card),
synchronised on both ends: the scene front end's share of setup_s."""


def read(run):
    spans = run.spans.get("scene_build")
    return spans[0] if spans else None
