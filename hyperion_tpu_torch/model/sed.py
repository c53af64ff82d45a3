"""Re-export of the SED product class (see products.py)."""

from .products import SED

__all__ = ["SED"]
