"""Flared disk: the plain Gaussian-profile disk of densities/core.py with no
radial taper (functional counterpart of hyperion/densities/flared_disk.py).

    rho(w, z) = rho_0 (r_0/w)^(beta-p) exp(-z^2 / 2 h(w)^2),
    h(w) = h_0 (w/r_0)^beta.
"""

from .core import Disk

__all__ = ["FlaredDisk"]


class FlaredDisk(Disk):
    """All behaviour — the mass <-> rho_0 coupling, rim truncation, grid
    normalization, midplane/vertical column integrals — lives in
    :class:`~hyperion_tpu_torch.densities.core.Disk`."""
