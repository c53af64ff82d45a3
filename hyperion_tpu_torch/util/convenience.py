"""Deferred-radius helpers.

Density structures accept ``OptThinRadius`` wherever a physical radius is
expected; the actual value is resolved at ``Model.write()`` time, once both
the central star and the dust properties are known (ref:
hyperion/util/convenience.py — re-derived here from the optically-thin
radiative-equilibrium balance; the two-branch small-x expansion of the
reference is replaced by the algebraically exact form ``4 w (1 - w)`` which
has no cancellation and needs no branch).
"""

import numpy as np

__all__ = ["OptThinRadius"]


class OptThinRadius:
    """Radius at which optically-thin dust reaches a given temperature.

    A grain in LTE at distance ``r`` from a star satisfies

        kappa_planck(T_d) * T_d**4 = W(r) * kappa_star * T_***4

    with dilution factor ``W(r) = (1 - sqrt(1 - (R_*/r)**2)) / 2``.
    Inverting for ``r`` gives ``r = R_* / (2 sqrt(W (1 - W)))``.

    Parameters
    ----------
    temperature : float
        Target dust temperature [K].
    value : float
        Multiplicative scale applied to the resolved radius (so that
        expressions like ``5 * OptThinRadius(1600)`` work).
    min : float
        Lower clamp on the resolved radius [cm].
    """

    def __init__(self, temperature, value=1.0, min=0.0):
        self.temperature = float(temperature)
        self.value = value
        self.min = min

    def _scaled(self, factor):
        return OptThinRadius(self.temperature,
                             value=self.value * factor, min=self.min)

    __mul__ = _scaled
    __rmul__ = _scaled

    def __str__(self):
        return ("<OptThinRadius: %g x r(T_thin = %g K)>"
                % (self.value, self.temperature))

    __repr__ = __str__

    def evaluate(self, star, dust):
        """Resolve to a radius in cm for the given star and dust."""
        t_star = star.effective_temperature()
        props = dust.optical_properties
        nu, fnu = star.total_spectrum(bnu_range=(props.nu[0], props.nu[-1]))

        # Ratio of absorbed to emitted efficiency-weighted fluxes: this is
        # the dilution factor W at the sought radius.
        kp_emit = dust.kappa_nu_temperature(self.temperature)
        kp_abs = dust.kappa_nu_spectrum(nu, fnu)
        w = (self.temperature / t_star) ** 4 * kp_emit / kp_abs

        # r = R* / sqrt(1 - (1 - 2W)^2); expand the square exactly to
        # 4 W (1 - W) — stable for W -> 0 without a series branch.
        arg = 4.0 * w * (1.0 - w)
        if not arg > 0.0:  # also catches NaN
            raise ValueError(
                "cannot resolve optically thin radius for T=%g K "
                "(dilution factor W=%g)" % (self.temperature, w))
        radius = self.value * star.radius / np.sqrt(arg)
        return radius if radius > self.min else self.min
