from .image import Image, load_image, to_rgb8  # noqa: F401
