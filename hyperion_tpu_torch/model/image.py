"""Re-export of the Image product class (see products.py)."""

from .products import Image

__all__ = ["Image"]
