from .types import (Scene, Triangles, Spheres, Cones, Lights,  # noqa: F401
                    Materials, Textures, Fog, BVH)
from .build import SceneBuilder  # noqa: F401
