# Copy of image_transformation_tpu/serving/__init__.py.
from .server import ComposeService, main, serve  # noqa: F401
