"""Ulrich (1976) rotationally flattened infalling envelope (functional
counterpart of hyperion/densities/ulrich_envelope.py).

    rho = rho_0 (r/rc)^-3/2 (1 + mu/mu0)^-1/2 (mu/mu0 + 2 mu0^2 rc/r)^-1,

with mu0 the streamline root of ``mu0^3 + mu0 (r/rc - 1) - mu (r/rc) = 0``.
The solver is a vectorized trigonometric/Cardano cubic that picks the
physical root (same sign as mu, |mu0| <= 1), replacing the reference's
per-branch complex-root bookkeeping.
"""

import numpy as np

from ..util.constants import pi, G
from .core import Envelope, linked

__all__ = ["UlrichEnvelope", "solve_mu0"]


def solve_mu0(ratio, mu):
    """Solve mu0^3 + (ratio - 1) mu0 - mu*ratio = 0 for the physical root."""
    p = np.asarray(ratio, float) - 1.0
    q = -np.asarray(mu, float) * np.asarray(ratio, float)
    # roots of x^3 + p x + q = 0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    mu0 = np.zeros(np.broadcast(p, q).shape)

    pos = disc >= 0.0
    if np.any(pos):
        sq = np.sqrt(disc[pos])
        u = np.cbrt(-q[pos] / 2.0 + sq)
        v = np.cbrt(-q[pos] / 2.0 - sq)
        mu0[pos] = u + v

    neg = ~pos
    if np.any(neg):
        # three real roots; pick the one matching sign(mu) with |mu0|<=1
        pn = p[neg]
        qn = q[neg]
        mn = np.asarray(np.broadcast_to(mu, mu0.shape), float)[neg]
        rr = np.sqrt(-pn ** 3 / 27.0)
        theta = np.arccos(np.clip(-qn / (2.0 * rr), -1.0, 1.0))
        m = 2.0 * np.sqrt(-pn / 3.0)
        roots = np.stack([m * np.cos((theta + 2.0 * np.pi * k) / 3.0)
                          for k in range(3)])
        # physical root: same sign as mu (or >= 0 for mu = 0), magnitude
        # in [|mu|, 1]
        sign_ok = np.where(mn[None, :] >= 0, roots >= -1e-10, roots <= 1e-10)
        mag_ok = np.abs(roots) <= 1.0 + 1e-8
        good = sign_ok & mag_ok
        # among valid roots pick the one with the largest magnitude (the
        # streamline root; the others correspond to other branches)
        score = np.where(good, np.abs(roots), -1.0)
        pick = np.argmax(score, axis=0)
        mu0[neg] = roots[pick, np.arange(roots.shape[1])]

    return mu0


class UlrichEnvelope(Envelope):

    from .core import scalar_attribute as _sa
    rc = _sa("rc", doc="Centrifugal radius (cm).")
    del _sa

    _required = ("rmin", "rmax", "rc")
    _pairs = (("mdot", "rho_0"),)

    mdot = linked("mdot", "rho_0", "_mdot_per_rho0", forward=True,
                  doc="Infall rate (g/s).")
    rho_0 = linked("rho_0", "mdot", "_mdot_per_rho0", forward=False,
                   doc="Density factor (g/cm^3).")

    def __init__(self, mdot=None, rho_0=None, rmin=None, rmax=None, rc=None,
                 ambient_density=0.0, star=None):
        object.__setattr__(self, "_mdot", None)
        object.__setattr__(self, "_rho_0", None)
        self._base_init()
        self.rmin = rmin
        self.rmax = rmax
        self.rc = rc
        if mdot is not None and rho_0 is not None:
            raise Exception("Cannot specify both mdot and rho_0")
        if mdot is not None:
            self.mdot = mdot
        elif rho_0 is not None:
            self.rho_0 = rho_0
        self.star = star
        self._freeze()

    def _mdot_per_rho0(self):
        """Mdot / rho_0 = 4 pi sqrt(G M rc^3) for free-fall onto mass M."""
        if self.star is None or self.star.mass is None:
            raise Exception("Stellar mass is undefined - cannot relate "
                            "infall rate and density factor")
        return 4.0 * pi * np.sqrt(G * self.star.mass * self.rc ** 3)

    def exists(self):
        return self.rho_0 > 0.0

    # -- midplane limits of the Ulrich profile ----------------------------------

    def _midplane_profile(self, ratio):
        """rho/rho_0 exactly on the midplane (mu = 0), where the general
        expression is 0/0: inside rc the streamline root is mu0 = sqrt(1 -
        ratio), outside it is mu0 = 0."""
        ratio = np.asarray(ratio, float)
        with np.errstate(divide="ignore", invalid="ignore"):
            inner = 0.5 / (np.sqrt(ratio) * (1.0 - ratio))
            outer = 1.0 / (np.sqrt(2.0 * ratio - 1.0) * (ratio - 1.0))
        return np.where(ratio < 1.0, inner, outer)

    def density(self, grid, ignore_cavity=False):
        """Evaluate rho on a spherical/cylindrical polar grid (g/cm^3)."""
        self._check_all_set()
        if self.rmax <= self.rmin:
            return np.zeros(grid.shape)

        r, mu = self._polar_coords(grid)[:2]
        ratio = r / self.rc
        mu0 = solve_mu0(ratio, mu)
        with np.errstate(divide="ignore", invalid="ignore"):
            rho = (self.rho_0 * ratio ** -1.5
                   * (1.0 + mu / mu0) ** -0.5
                   * (mu / mu0 + 2.0 * mu0 ** 2 / ratio) ** -1.0)

        # cells exactly on the midplane need the analytic limit
        on_mid = np.abs(mu) < 1.0e-10
        if np.any(on_mid & (ratio == 1.0)):
            raise Exception("Grid point too close to Ulrich singularity")
        rho = np.where(on_mid, self.rho_0 * self._midplane_profile(ratio), rho)

        return self._apply_bounds_and_cavity(rho, r, grid, ignore_cavity)

    def outermost_radius(self, rho):
        """Radius where the midplane density drops to rho (fixed point of the
        large-r midplane asymptote)."""
        r = self.rc
        for _ in range(100):
            r_new = self.rc * (self.rho_0 / rho) ** (2.0 / 3.0) / \
                (2.0 * r / self.rc) ** (1.0 / 3.0) if r > 0 else self.rc
            if abs(r_new - r) / max(r_new, 1e-300) < 1e-10:
                break
            r = r_new
        return r

    def midplane_cumulative_density(self, r):
        """Column density along the midplane from rmin to r (numeric)."""
        self._check_all_set()
        r = np.asarray(r, float)
        out = np.zeros(r.shape)
        for i, rr in enumerate(r.flat):
            hi = max(rr, self.rmin * (1.0 + 1e-10))
            rs = np.logspace(np.log10(self.rmin), np.log10(hi), 200)
            rho = self.rho_0 * self._midplane_profile(rs / self.rc)
            rho[~np.isfinite(rho)] = 0.0
            out.flat[i] = np.trapezoid(np.maximum(rho, 0.0), rs)
        return out
