"""Spectral data products returned by :class:`ModelOutput`.

``SED`` and ``Image`` are thin value containers over the same core: a flux
cube defined on a frequency grid, optional Monte-Carlo uncertainties, a unit
string, and a set of geometry attributes that differ per product (apertures
for SEDs, a pixel viewport for images).

Functional counterpart of hyperion/model/sed.py and image.py, rebuilt as a
single slotted base class; the metadata surface (attribute names) matches the
reference because downstream user code reads those names.
"""

import numpy as np

from ..util.constants import c

__all__ = ["SED", "Image"]


class SpectralProduct:
    """Flux values on a frequency grid plus product metadata."""

    # Geometry/metadata attributes each concrete product carries, and their
    # defaults. Subclasses extend this table instead of writing __init__s.
    _meta = ("d_min", "d_max", "distance", "inside_observer")

    __slots__ = ("nu", "val", "unc", "units",
                 "d_min", "d_max", "distance", "inside_observer")

    def __init__(self, nu=None, val=None, unc=None, units=None, **meta):
        self.nu = None if nu is None else np.atleast_1d(np.asarray(nu))
        self.val = val
        self.unc = unc
        self.units = units
        for key in self._meta:
            setattr(self, key, meta.pop(key, None))
        if meta:
            raise TypeError("unexpected metadata: %s" % sorted(meta))
        self._validate()

    def _validate(self):
        for name in ("val", "unc"):
            cube = getattr(self, name)
            if cube is None or self.nu is None:
                continue
            if np.shape(cube)[-1] != self.nu.size:
                raise ValueError(
                    "%s has %d frequency planes but nu has %d"
                    % (name, np.shape(cube)[-1], self.nu.size))
        if (self.val is not None and self.unc is not None
                and np.shape(self.val) != np.shape(self.unc)):
            raise ValueError("val and unc shapes differ")

    # -- derived views --------------------------------------------------------

    @property
    def wav(self):
        """Wavelength grid in microns (descending for ascending nu)."""
        return 1.0e4 * c / self.nu

    @property
    def flux(self):
        return self.val

    @property
    def unit(self):
        return self.units

    def __iter__(self):
        # Legacy tuple unpacking: (wav, val[, unc])
        parts = (self.wav, self.val) if self.unc is None else \
                (self.wav, self.val, self.unc)
        return iter(parts)

    def __repr__(self):
        shape = None if self.val is None else np.shape(self.val)
        return "<%s shape=%r units=%r>" % (type(self).__name__,
                                           shape, self.units)


class SED(SpectralProduct):
    """An SED: fluxes per (viewing angle, aperture, frequency)."""

    _meta = SpectralProduct._meta + ("ap_min", "ap_max")
    __slots__ = ("ap_min", "ap_max")


class Image(SpectralProduct):
    """An image cube: fluxes per (viewing angle, y, x, frequency)."""

    _meta = SpectralProduct._meta + (
        "x_min", "x_max", "y_min", "y_max",
        "lon_min", "lon_max", "lat_min", "lat_max", "pix_area_sr")
    __slots__ = ("x_min", "x_max", "y_min", "y_max",
                 "lon_min", "lon_max", "lat_min", "lat_max", "pix_area_sr")
