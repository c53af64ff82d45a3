"""Shared machinery for the analytic density structures.

The reference (hyperion/densities/*.py) repeats three patterns in every
class: a pair of mutually-derivable scale quantities (mass <-> rho_0,
mdot <-> lvisc, ...), rmin/rmax attributes that may be lazy
:class:`~hyperion_tpu_torch.util.convenience.OptThinRadius` markers, and
required-attribute checks. Here those patterns are hoisted into descriptors
and declarative class tables so each density class states only its physics.
"""

import numpy as np

from ..util.constants import pi
from ..util.convenience import OptThinRadius
from ..util.functions import FreezableClass
from ..util.integrate import integrate_powerlaw
from ..util.validator import validate_scalar

__all__ = ["Density", "Disk", "Envelope", "linked", "radius_attribute"]


class linked:
    """One half of a coupled scale-quantity pair (e.g. ``mass``/``rho_0``).

    Exactly one of the pair is ever *stored*; assigning to either slot
    invalidates the other, and reading the unset one derives it through the
    owner's conversion factor (``value = partner * factor`` in the forward
    direction). A zero factor — e.g. a disk with ``rmax <= rmin`` — makes
    both sides read as 0 rather than dividing by zero, which matches the
    reference's degenerate-geometry behaviour.
    """

    def __init__(self, name, partner, factor, forward, doc=None):
        self.name = name
        self.slot = "_" + name
        self.partner_slot = "_" + partner
        self.factor = factor
        self.forward = forward
        self.__doc__ = doc

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        stored = getattr(obj, self.slot)
        if stored is not None:
            return stored
        partner = getattr(obj, self.partner_slot)
        if partner is None:
            return None
        obj._check_all_set()
        factor = getattr(obj, self.factor)()
        if self.forward:
            return partner * factor
        return partner / factor if factor != 0.0 else 0.0

    def __set__(self, obj, value):
        if value is not None:
            validate_scalar(self.name, value, domain="positive")
            object.__setattr__(obj, self.partner_slot, None)
        object.__setattr__(obj, self.slot, value)


class scalar_attribute:
    """Validated plain scalar attribute (ref: the reference validates every
    density property setter — 'x should be positive' / 'x should be a
    numerical value' / 'x should be a scalar value')."""

    def __init__(self, name, positive=True, doc=None):
        self.name = name
        self.slot = "_sv_" + name
        self.positive = positive
        self.__doc__ = doc

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return getattr(obj, self.slot, None)

    def __set__(self, obj, value):
        if value is not None:
            validate_scalar(self.name, value,
                            domain="positive" if self.positive else None)
        object.__setattr__(obj, self.slot, value)


class radius_attribute:
    """rmin/rmax-style attribute accepting a float or an OptThinRadius.

    Reading resolves an OptThinRadius against the structure's ``star`` and
    ``dust`` (both must be attached by then).
    """

    def __init__(self, name, doc=None):
        self.name = name
        self.slot = "_" + name
        self.__doc__ = doc

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        raw = getattr(obj, self.slot)
        if not isinstance(raw, OptThinRadius):
            return raw
        if getattr(obj, "star", None) is None or obj.dust is None:
            raise Exception(
                "%s is an OptThinRadius but star/dust are not set" % self.name)
        return raw.evaluate(obj.star, obj.dust)

    def __set__(self, obj, value):
        if value is not None and not isinstance(value, OptThinRadius):
            validate_scalar(self.name, value, domain="positive",
                            extra=" or an OptThinRadius instance")
        object.__setattr__(obj, self.slot, value)


class Density(FreezableClass):
    """Base for all analytic density structures.

    Subclasses declare:

    - ``_required``: attribute names that must be non-None before evaluation;
    - ``_pairs``: ``(name_a, name_b)`` tuples of linked quantities, of which
      at least one per pair must be set;
    - the physics (``density`` and friends).
    """

    _required = ()
    _pairs = ()

    rmin = radius_attribute("rmin", "Inner radius (cm).")
    rmax = radius_attribute("rmax", "Outer radius (cm).")

    def _base_init(self):
        object.__setattr__(self, "_rmin", None)
        object.__setattr__(self, "_rmax", None)
        self.star = None
        self.dust = None

    def _check_all_set(self):
        for attr in self._required:
            if getattr(self, attr) is None:
                raise Exception("%s is not set" % attr)
        for name_a, name_b in self._pairs:
            if (getattr(self, "_" + name_a) is None
                    and getattr(self, "_" + name_b) is None):
                raise Exception("%s or %s is not set" % (name_a, name_b))

    def exists(self):
        return True

    @staticmethod
    def _polar_coords(grid):
        """(spherical radius, cos(theta), cylindrical radius, z) per cell."""
        from ..grid import CylindricalPolarGrid, SphericalPolarGrid
        if isinstance(grid, SphericalPolarGrid):
            r = grid.gr
            mu = np.cos(grid.gt)
        elif isinstance(grid, CylindricalPolarGrid):
            r = np.hypot(grid.gw, grid.gz)
            with np.errstate(invalid="ignore", divide="ignore"):
                mu = np.where(r > 0, grid.gz / np.maximum(r, 1e-300), 0.0)
        else:
            raise TypeError("grid should be a SphericalPolarGrid or "
                            "CylindricalPolarGrid instance")
        return r, mu, grid.gw, grid.gz


class Disk(Density):
    """Gaussian-vertical-profile disk:

        rho(w, z) = rho_0 (r_0/w)^(beta-p) T(w) exp(-z^2 / 2 h(w)^2),
        h(w) = h_0 (w/r_0)^beta,

    with a radial taper ``T(w)`` hook (identity here; AlphaDisk overrides),
    truncated at rmin/rmax by cylindrical or spherical rims and renormalized
    to the analytic total mass on the discretized grid.
    """

    _required = ("rmin", "rmax", "h_0", "r_0")
    _pairs = (("mass", "rho_0"),)

    p = scalar_attribute("p", positive=False,
                         doc="Surface-density radial exponent.")
    beta = scalar_attribute("beta", positive=False,
                            doc="Scale-height flaring exponent.")
    h_0 = scalar_attribute("h_0", doc="Scale height at r_0 (cm).")
    r_0 = scalar_attribute("r_0", doc="Reference radius (cm).")

    mass = linked("mass", "rho_0", "_mass_per_rho0", forward=True,
                  doc="Total disk mass (g).")
    rho_0 = linked("rho_0", "mass", "_mass_per_rho0", forward=False,
                   doc="Density scale factor (g/cm^3).")

    def __init__(self, mass=None, rho_0=None, rmin=None, rmax=None, p=-1,
                 beta=-1.25, h_0=None, r_0=None, cylindrical_inner_rim=True,
                 cylindrical_outer_rim=True, dust=None):
        object.__setattr__(self, "_mass", None)
        object.__setattr__(self, "_rho_0", None)
        self._base_init()
        self.rmin = rmin
        self.rmax = rmax
        self.p = p
        self.beta = beta
        self.h_0 = h_0
        self.r_0 = r_0
        self.cylindrical_inner_rim = cylindrical_inner_rim
        self.cylindrical_outer_rim = cylindrical_outer_rim
        self.dust = dust
        if mass is not None and rho_0 is not None:
            raise Exception("Cannot specify both mass and rho_0")
        if mass is not None:
            self.mass = mass
        elif rho_0 is not None:
            self.rho_0 = rho_0
        self._freeze()

    # -- analytics -------------------------------------------------------------

    def _mass_per_rho0(self):
        """Analytic untapered integral of the profile over all space:
        (2 pi)^{3/2} h_0 r_0^{-p} * int_{rmin}^{rmax} w^{1+p} dw."""
        if self.rmax <= self.rmin:
            return 0.0
        radial = integrate_powerlaw(self.rmin, self.rmax, 1.0 + self.p)
        return (2.0 * pi) ** 1.5 * self.h_0 * radial * self.r_0 ** -self.p

    def scale_height_at(self, r):
        """Disk scale height h(r) = h_0 (r/r_0)^beta."""
        return self.h_0 * (r / self.r_0) ** self.beta

    def _radial_taper(self, w):
        """Dimensionless radial modulation of the surface density."""
        return 1.0

    # -- evaluation ------------------------------------------------------------

    def _inside_rims(self, grid):
        """Boolean mask of cells between the (cyl or sph) rims."""
        r_sph = np.hypot(grid.gw, grid.gz)
        inner = grid.gw if self.cylindrical_inner_rim else r_sph
        outer = grid.gw if self.cylindrical_outer_rim else r_sph
        return (inner >= self.rmin) & (outer <= self.rmax)

    def density(self, grid):
        """Evaluate rho on a spherical/cylindrical polar grid (g/cm^3)."""
        self._check_all_set()
        if self.rmax <= self.rmin or self.mass == 0:
            return np.zeros(grid.shape)

        h = self.scale_height_at(grid.gw)
        with np.errstate(invalid="ignore"):
            shape = ((self.r_0 / grid.gw) ** (self.beta - self.p)
                     * self._radial_taper(grid.gw)
                     * np.exp(-0.5 * (grid.gz / h) ** 2))
        rho = np.where(self._inside_rims(grid), shape, 0.0) * self.rho_0

        discretized = np.sum(rho * grid.volumes)
        if discretized == 0.0 and self.mass > 0:
            raise Exception("Discretized disk mass is zero, suggesting that "
                            "the grid is too coarse")
        return rho * (self.mass / discretized)

    def midplane_cumulative_density(self, r):
        """Column density integrated along the midplane from rmin to r."""
        self._check_all_set()
        radial = integrate_powerlaw(self.rmin, np.asarray(r, float),
                                    self.p - self.beta)
        return self.rho_0 * self.r_0 ** (self.beta - self.p) * radial

    def vertical_cumulative_density(self, r, theta):
        """Column from the midplane along polar angle theta at radius r."""
        from scipy.special import erf
        self._check_all_set()
        h = self.scale_height_at(r)
        z = r * np.cos(theta)
        rho_mid = self.rho_0 * (self.r_0 / r) ** (self.beta - self.p)
        return rho_mid * h * np.sqrt(pi / 2.0) * erf(np.abs(z) / (h * np.sqrt(2.0)))


class Envelope(Density):
    """Base for spherical-ish envelopes that may carry a bipolar cavity."""

    def _base_init(self):
        Density._base_init(self)
        self.cavity = None

    def add_bipolar_cavity(self):
        from .bipolar_cavity import BipolarCavity
        if self.cavity is not None:
            raise Exception("Envelope already has a bipolar cavity")
        self.cavity = BipolarCavity()
        self.cavity._envelope = self
        return self.cavity

    def _apply_bounds_and_cavity(self, rho, r, grid, ignore_cavity):
        rho = np.where((r >= self.rmin) & (r <= self.rmax), rho, 0.0)
        if not ignore_cavity and self.cavity is not None:
            rho = np.where(self.cavity.mask(grid), rho, 0.0)
        return rho
