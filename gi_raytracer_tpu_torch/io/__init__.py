from .image import save_png, load_png, load_png_rgba  # noqa: F401
from .checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
