from .imaging import get_image_size, load_image_resized
from .logging import format_loss_line, log

__all__ = ["get_image_size", "load_image_resized", "log", "format_loss_line"]
