from .loader import NativeImagePipe, build_library

__all__ = ["NativeImagePipe", "build_library"]
