from .imaging import get_image_size, load_image_resized

__all__ = ["get_image_size", "load_image_resized"]
