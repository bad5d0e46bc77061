"""Image frontend of the port: host decode (native or cv2), the prefetching
input pipeline and the device-side normalization."""
from . import frontend
from .frontend import (IMAGENET_MEAN, IMAGENET_STD, batch_paths, center_crop,
                       decode_image, load_square, normalize, rescale,
                       resize_shorter_side)

__all__ = ["frontend", "IMAGENET_MEAN", "IMAGENET_STD", "batch_paths",
           "center_crop", "decode_image", "load_square", "normalize",
           "rescale", "resize_shorter_side"]
