from .imaging import get_image_size, load_image_resized, plot_boxes, scale_bboxes
from .logging import format_loss_line, log

__all__ = [
    "get_image_size",
    "load_image_resized",
    "plot_boxes",
    "scale_bboxes",
    "log",
    "format_loss_line",
]
