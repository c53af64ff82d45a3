"""Post-processing and iteration helpers
(ref: hyperion/model/helpers.py:10-250).

``tau_to_radius`` finds the radial photosphere of a spherical-polar model;
``hseq_profile`` is the vertical hydrostatic-equilibrium density profile.
``run_with_vertical_hseq`` of ``hyperion_tpu/model/helpers.py`` iterates
an AnalyticalYSOModel on a cylindrical-polar grid, which the port does not
run yet (ROADMAP.md queue 1 item 11), so it is left out here.
"""

import numpy as np

MU_H2_HE = 2.279  # mean molecular weight of an H2 + He mix (X_He = 0.325)


def find_last_iteration(file_handle):
    """Largest N for which 'iteration_%05N' exists in an output file."""
    return max((int(name.rsplit('_', 1)[1]) for name in file_handle
                if name.startswith('iteration_')), default=0)


def tau_to_radius(model, tau, wav):
    """Radius at which the radial optical depth to infinity reaches ``tau``
    at wavelength ``wav`` (microns), per (phi, theta) column
    (ref helpers.py:19-77). Spherical-polar grids only.

    Returns an array of shape (n_phi, n_theta); 0 where the column never
    reaches ``tau``.
    """
    from .model import Model
    from ..grid import SphericalPolarGrid
    from ..dust import SphericalDust

    if not isinstance(model, Model):
        raise TypeError("model should be a Model instance")
    if not isinstance(model.grid, SphericalPolarGrid):
        raise TypeError("tau_to_radius requires a spherical polar grid")

    grid = model.grid
    # cumulative tau integrated inward from the outer edge, per population
    tau_cum = np.zeros(grid.shape)  # (n_phi, n_theta, n_r)
    for rho, dust in zip(grid['density'], model._dust_objects()):
        if isinstance(dust, str):
            dust = SphericalDust(dust)
        chi = dust.optical_properties.interp_chi_wav(wav)
        tau_cum += np.cumsum((grid.widths[0] * rho.array)[:, :, ::-1],
                             axis=2) * chi

    # walls, outside-in, with tau=0 at the outer wall
    r_desc = grid.r_wall[::-1]
    n_p, n_t, n_r = tau_cum.shape
    out = np.zeros((n_p, n_t))
    for ip in range(n_p):
        for it in range(n_t):
            col = np.concatenate([[0.0], tau_cum[ip, it]])
            if tau < col[-1]:
                out[ip, it] = np.interp(tau, col, r_desc)
    return out


def hseq_profile(w, z, temperature, mstar, mu=MU_H2_HE):
    """Normalized vertical density profile in hydrostatic equilibrium with
    the given temperature profile at cylindrical radius ``w``
    (ref helpers.py:80-116): rho(z) ∝ exp(-G M mu m_H / k * I(z)) / T(z)
    with I(z) = ∫_0^z z' / (T (w² + z'²)^{3/2}) dz'.
    """
    from ..util.constants import G, m_h, k

    z = np.asarray(z, float)
    temperature = np.asarray(temperature, float)
    integrand = z / (temperature * (w ** 2 + z ** 2) ** 1.5)

    # Cumulative trapezoid anchored at z=0. The integrand is odd in z, so
    # the signed cumulative (cum - cum(0)) IS the required I(z): negative
    # below the midplane, exactly mirroring the reference's explicit
    # sign flip for z < 0.
    seg = 0.5 * (integrand[1:] + integrand[:-1]) * np.diff(z)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    i_z = cum - np.interp(0.0, z, cum)

    rho = np.exp(-(G * mstar * mu * m_h / k) * i_z) / temperature
    trapz = np.trapezoid if hasattr(np, 'trapezoid') else np.trapz
    return rho / trapz(rho, z)
