"""Analytical YSO convenience model.

Functional counterpart of hyperion/model/analytical_yso_model.py: a central
:class:`Star` plus analytic disks/envelopes/ambient media, evaluated onto an
automatically refined polar grid, with magnetospheric accretion and midplane
optical-depth diagnostics. The grid-refinement recipes (resolve the tau=0.1
surface radially, crowd theta walls toward the midplane, resolve the disk
scale height vertically) follow the reference's documented behaviour
(ref analytical_yso_model.py:437-625) but are implemented as free functions
here.

A copy of ``hyperion_tpu/model/analytical_yso_model.py``; ``to_model``
passes the run configuration through an in-memory group instead of an
HDF5 file, so that a model builds where h5py is missing, and ``run`` runs
the port's engine (through the port's ``Model.run``).
"""

from copy import deepcopy

import numpy as np

from ..densities import (AlphaDisk, AmbientMedium, FlaredDisk,
                         PowerLawEnvelope, UlrichEnvelope)
from ..grid import CylindricalPolarGrid, SphericalPolarGrid
from ..sources import SphericalSource, SpotSource
from ..util.constants import G, c, pi, sigma
from ..util.convenience import OptThinRadius
from ..util.functions import FreezableClass
from ..util.interpolate import interp1d_fast_loglog
from .model import Model

__all__ = ["Star", "AnalyticalYSOModel"]


class _MemoryGroup(dict):
    """The part of an HDF5 group that ``write_run_conf`` and
    ``read_run_conf`` use: attributes and datasets, held in memory."""

    def __init__(self):
        dict.__init__(self)
        self.attrs = {}

    def create_dataset(self, name, data):
        self[name] = np.asarray(data)


# ---------------------------------------------------------------------------
# grid-wall construction helpers
# ---------------------------------------------------------------------------

def _extremum(values, pick):
    concrete = [v for v in values if v is not None]
    return pick(concrete) if concrete else None


def _auto_radial_walls(yso, n_r, rmin, rmax, min_spacing):
    """Radial walls: logarithmic from rmin to rmax, with the first step
    shrunk (if necessary) so the midplane tau=0.1 surface falls inside the
    first cell."""
    # Midplane optical depth on a dense trial grid hugging the inner edge.
    trial = rmin * (1.0 + np.logspace(-20.0, np.log10(rmax / rmin - 1.0),
                                      100000))
    trial[0] = rmin
    tau = yso.get_midplane_tau(trial)

    # First-step candidates: the plain logarithmic step, and the depth of
    # the tau=0.1 point (when the column ever reaches 0.1).
    step_log = rmin * ((rmax / rmin) ** (1.0 / n_r) - 1.0)
    if tau[-1] > 0.1:
        step_tau = np.interp(0.1, tau, trial) - rmin
    else:
        step_tau = rmax - rmin
    first = min(step_log, step_tau)
    if first < rmin * min_spacing:
        first = rmin * min_spacing

    interior = rmin * (1.0 + np.logspace(np.log10(first / rmin),
                                         np.log10(rmax / rmin - 1.0),
                                         n_r - 1))
    return np.concatenate([[0.0, rmin], interior])


def _midplane_crowded_theta(n_theta):
    """Theta walls biased toward the midplane: uniform spacing plus a
    sin(2t)/6 perturbation (denser near t = pi/2, still monotonic)."""
    t = np.linspace(0.0, pi, n_theta + 1)
    return t + np.sin(2.0 * t) / 6.0


def _disk_resolving_z_walls(n_z, z_disk, zmax):
    """Vertical walls for cylindrical grids: 10 linear walls inside the
    smallest disk scale height, log walls above, mirrored about z=0 (with a
    z=0 wall when n_z is odd)."""
    half = n_z // 2 if n_z % 2 == 0 else (n_z - 1) // 2
    fine = np.linspace(0.1 * z_disk, 0.9 * z_disk, 10)
    coarse = np.logspace(np.log10(z_disk), np.log10(zmax), half - 10)
    upper = np.concatenate([fine, coarse])
    mid = [] if n_z % 2 == 0 else [0.0]
    return np.concatenate([-upper[::-1], mid, upper])


# ---------------------------------------------------------------------------
# the central star
# ---------------------------------------------------------------------------

class Star(FreezableClass):
    """The central star: a primary SphericalSource plus optional accretion
    components ('uv', 'xray') that always share its radius.

    ``luminosity``/``temperature``/``spectrum`` delegate to the primary
    source only; ``radius``/``limb`` fan out to every component.
    """

    _primary_attrs = frozenset(("luminosity", "temperature", "spectrum"))
    _shared_attrs = frozenset(("radius", "limb"))

    def __init__(self):
        self.sources = {"star": SphericalSource(name="star")}
        self.mass = None
        self.radius = None
        self.limb = False
        self._freeze()

    def add_spot(self, *args, **kwargs):
        self.sources["star"].spots.append(SpotSource(*args, **kwargs))

    def __setattr__(self, name, value):
        if name in self._primary_attrs:
            setattr(self.sources["star"], name, value)
            return
        if name in self._shared_attrs:
            for component in self.sources.values():
                setattr(component, name, value)
        FreezableClass.__setattr__(self, name, value)

    def __getattr__(self, name):
        if name in Star._primary_attrs or name in Star._shared_attrs:
            return getattr(self.__dict__["sources"]["star"], name)
        raise AttributeError(name)

    def total_luminosity(self):
        """Total luminosity over all stellar components (erg/s)."""
        return sum(s.luminosity for s in self.sources.values()
                   if s.luminosity is not None)

    def effective_temperature(self):
        """Effective temperature implied by the total luminosity (K)."""
        return (self.total_luminosity()
                / (4.0 * pi * sigma * self.radius ** 2)) ** 0.25

    def total_spectrum(self, bnu_range=None):
        """Co-added (nu, fnu) spectrum of all stellar components, on the
        union of their frequency grids."""
        spectra = []
        for component in self.sources.values():
            if component.temperature is not None:
                if bnu_range is None:
                    raise ValueError("bnu_range is needed for sources with "
                                     "Planck spectra")
                spectra.append(component.get_spectrum(nu_range=bnu_range))
            else:
                spectra.append(component.get_spectrum())

        grid = np.unique(np.concatenate([nu for nu, _ in spectra]))
        total = np.zeros_like(grid)
        for nu, fnu in spectra:
            covered = (grid >= nu[0]) & (grid <= nu[-1])
            total[covered] += interp1d_fast_loglog(nu, fnu, grid[covered])
        return grid, total


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class AnalyticalYSOModel(Model):

    def __init__(self, name=None):
        self.star = Star()
        self.disks = []
        self.envelopes = []
        self.ambients = []
        self._evaluated_model = None
        Model.__init__(self, name=name)

    def add_density_grid(self, *args, **kwargs):
        raise NotImplementedError("add_density_grid cannot be used for "
                                  "AnalyticalYSOModel")

    # -- density components ---------------------------------------------------

    def _attach(self, component, registry):
        component.star = self.star
        registry.append(component)
        return component

    def add_flared_disk(self):
        return self._attach(FlaredDisk(), self.disks)

    def add_alpha_disk(self):
        return self._attach(AlphaDisk(), self.disks)

    def add_ulrich_envelope(self):
        return self._attach(UlrichEnvelope(), self.envelopes)

    def add_power_law_envelope(self):
        return self._attach(PowerLawEnvelope(), self.envelopes)

    def add_ambient_medium(self, subtract=[]):
        """Add a constant-density ambient medium (optionally subtracting
        other components so the total never drops below rho)."""
        ambient = self._attach(AmbientMedium(), self.ambients)
        ambient.subtract = subtract
        return ambient

    def add_settled_disks(self, reference_disk, reference_size, eta=0.0,
                          sizes=[], dust_files=[]):
        """Clone ``reference_disk`` once per grain size, scaling each clone's
        scale height by (size/reference_size)^-eta (dust settling;
        ref analytical_yso_model.py:197-222)."""
        if not any(d is reference_disk for d in self.disks):
            raise Exception("Reference disk not found in disk list")
        for size, dust in zip(sizes, dust_files):
            clone = deepcopy(reference_disk)
            clone.h_0 *= (size / reference_size) ** -eta
            clone.dust = dust
            self._attach(clone, self.disks)

    def _components(self):
        return self.disks + self.envelopes + self.ambients

    def _check_all_set(self):
        for component in self._components():
            component._check_all_set()

    # -- midplane optical depth diagnostics -----------------------------------

    def _spectrum_weighted_chi(self, dust):
        """chi of ``dust`` weighted by the star's spectrum (cm^2/g)."""
        props = dust.optical_properties
        nu, fnu = self.star.total_spectrum(
            bnu_range=[props.nu[0], props.nu[-1]])
        return dust.chi_nu_spectrum(nu, fnu)

    def get_midplane_tau(self, r):
        """Combined midplane optical depth out to radii ``r``, weighting
        each component's opacity by the stellar spectrum."""
        self._check_all_set()
        tau = np.zeros(np.asarray(r).shape)
        for disk in self.disks:
            if disk.mass > 0.0:
                tau += (disk.midplane_cumulative_density(r)
                        * self._spectrum_weighted_chi(disk.dust))
        for envelope in self.envelopes:
            if envelope.exists():
                tau += (envelope.midplane_cumulative_density(r)
                        * self._spectrum_weighted_chi(envelope.dust))
        return tau

    def print_midplane_tau(self, wavelength):
        for i, disk in enumerate(self.disks):
            if disk.mass > 0.0:
                chi = disk.dust.optical_properties.interp_chi_wav(wavelength)
                tau = disk.midplane_cumulative_density(
                    np.array([disk.rmax])) * chi
                print("Disk %i: %.5e" % (i + 1, tau))

    def radial_range(self):
        """(rmin, rmax) span of all the density components."""
        components = self._components()
        if not components:
            return self.star.radius, self.star.radius
        return (_extremum([s.rmin for s in components], min),
                _extremum([s.rmax for s in components], max))

    # -- automated grids ------------------------------------------------------

    def set_spherical_polar_grid_auto(self, n_r, n_theta, n_phi, rmax=None,
                                      min_spacing=1.e-8):
        self.grid = dict(grid_type="spherical", n1=n_r, n2=n_theta, n3=n_phi,
                         rmax=rmax, min_spacing=min_spacing)

    def set_cylindrical_polar_grid_auto(self, n_w, n_z, n_phi, wmin=None,
                                        wmax=None, zmin=None, zmax=None,
                                        min_spacing=1.e-8):
        self.grid = dict(grid_type="cylindrical", n1=n_w, n2=n_z, n3=n_phi,
                         rmin=wmin, rmax=wmax, zmin=zmin, zmax=zmax,
                         min_spacing=min_spacing)

    def _set_polar_grid_auto(self, n1=None, n2=None, n3=None, grid_type=None,
                             zmin=None, zmax=None, rmin=None, rmax=None,
                             min_spacing=1.e-8):
        """Build the refined polar grid (see the module helpers)."""
        if self.star.radius is None:
            raise Exception("The central source radius need to be defined "
                            "before the grid can be set up")
        if grid_type not in ("spherical", "cylindrical"):
            raise Exception("Unknown grid type: %s" % grid_type)

        if rmin is None:
            inner = [s.rmin for s in self._components()]
            rmin = _extremum(inner, min) if inner else self.star.radius
        if rmax is None:
            rmax = _extremum([2.0 * self.star.radius]
                             + [s.rmax for s in self._components()], max)
        if rmax < rmin:
            rmin, rmax = self.star.radius, 2.0 * self.star.radius
        if np.isnan(rmin) or np.isnan(rmax):
            raise Exception("R_min or R_max is NaN")
        if rmin == 0:
            raise ValueError("R_min is 0, so cannot set up the grid cell "
                             "walls automatically")

        r_wall = _auto_radial_walls(self, n1, rmin, rmax, min_spacing)
        p_wall = np.linspace(0.0, 2.0 * pi, n3 + 1)

        if grid_type == "spherical":
            return SphericalPolarGrid(r_wall,
                                      _midplane_crowded_theta(n2), p_wall)

        if not zmax:
            zmax = rmax
        if zmin is None and self.disks:
            zmin = min(d.scale_height_at(rmin) for d in self.disks)
        if zmin is None:
            z_wall = np.linspace(-zmax, zmax, n2 + 1)
        else:
            z_wall = _disk_resolving_z_walls(n2, zmin, zmax)
        return CylindricalPolarGrid(r_wall, z_wall, p_wall)

    # -- accretion ------------------------------------------------------------

    def setup_magnetospheric_accretion(self, mdot, rtrunc, fspot,
                                       xwav_min=0.001, xwav_max=0.01):
        """Split the accretion-shock luminosity L = G M Mdot (1/R* - 1/Rtrunc)
        into a hot-spot blackbody ('uv') and a flat X-ray component
        (ref analytical_yso_model.py:627-688). The primary star keeps
        (1 - fspot) of its photospheric luminosity."""
        if self.star.mass is None:
            raise Exception("Stellar mass is not set")
        photosphere = self.star.sources["star"].luminosity
        l_shock = G * self.star.mass * mdot * (1.0 / self.star.radius
                                               - 1.0 / rtrunc)

        # Spot temperature: photospheric T_eff boosted by the extra flux
        # running through the spot covering fraction.
        t_eff = (photosphere
                 / (4.0 * pi * sigma * self.star.radius ** 2)) ** 0.25
        t_spot = t_eff * (1.0 + 0.5 * l_shock / (photosphere * fspot)) ** 0.25

        uv = SphericalSource(name="uv", radius=self.star.radius)
        uv.luminosity = 0.5 * l_shock + photosphere * fspot
        uv.temperature = t_spot
        self.star.sources["uv"] = uv

        # Flat f_nu between the two X-ray wavelengths (microns).
        wav = np.logspace(np.log10(xwav_min), np.log10(xwav_max), 100)[::-1]
        xray = SphericalSource(name="xray", radius=self.star.radius)
        xray.luminosity = 0.5 * l_shock
        xray.spectrum = (1.0e4 * c / wav, np.ones(wav.shape))
        self.star.sources["xray"] = xray

        self.star.sources["star"].luminosity = photosphere * (1.0 - fspot)

    # -- evaluation to a plain Model -------------------------------------------

    def evaluate_optically_thin_radii(self):
        """Freeze all OptThinRadius rmin/rmax into concrete values."""
        for component in self._components():
            for attr in ("rmin", "rmax"):
                if isinstance(getattr(component, "_" + attr), OptThinRadius):
                    setattr(component, attr, getattr(component, attr))

    @staticmethod
    def _disk_is_empty(disk):
        return disk.rmin >= disk.rmax or disk.mass == 0.0

    @staticmethod
    def _envelope_is_empty(envelope):
        if envelope.rmin >= envelope.rmax:
            return True
        if isinstance(envelope, UlrichEnvelope):
            return envelope.rho_0 == 0.0
        return envelope.mass == 0.0

    def to_model(self, merge_if_possible=True):
        """Evaluate the analytic structure onto the grid and return a plain
        Model (ref analytical_yso_model.py:689-832)."""
        if self.grid is None:
            raise Exception("The coordinate grid needs to be defined")

        m = Model()
        if isinstance(self.grid, dict):
            m.grid = self._set_polar_grid_auto(**self.grid)
        else:
            m.grid = deepcopy(self.grid)

        m.name = self.name
        for attr in ("conf", "sources", "binned_output", "peeled_output",
                     "_minimum_temperature", "_minimum_specific_energy"):
            setattr(m, attr, deepcopy(getattr(self, attr)))
        m._monochromatic = self._monochromatic
        m._frequencies = self._frequencies

        # run configuration travels through its own HDF5 schema, held in
        # memory (no HDF5 needed)
        buf = _MemoryGroup()
        self.write_run_conf(buf)
        m.read_run_conf(buf)

        def deposit(structure, what):
            if not structure.dust:
                raise Exception("%s dust not set" % what)
            m.add_density_grid(structure.density(m.grid), structure.dust,
                               merge_if_possible=merge_if_possible)

        for i, disk in enumerate(self.disks):
            if not self._disk_is_empty(disk):
                deposit(disk, "Disk %i" % (i + 1))

        for envelope in self.envelopes:
            if self._envelope_is_empty(envelope):
                continue
            deposit(envelope, "Envelope")
            cavity = envelope.cavity
            if cavity is not None and cavity.theta_0 != 0.0 and cavity.rho_0:
                deposit(cavity, "Cavity")

        for ambient in self.ambients:
            if ambient.rho != 0.0:
                deposit(ambient, "Ambient medium")

        # stellar components with non-zero luminosity become sources
        for component in self.star.sources.values():
            if component.luminosity and component not in self.sources:
                m.add_source(component)

        # viscous disks radiate from a luminosity map
        for i, disk in enumerate(self.disks):
            if isinstance(disk, AlphaDisk) and not self._disk_is_empty(disk) \
                    and disk.lvisc:
                m.add_map_source(luminosity=disk.lvisc,
                                 map=disk.accretion_luminosity_grid(m.grid),
                                 name="accdisk%i" % i)

        return m

    def write(self, filename=None, compression=True, copy=True,
              absolute_paths=False, wall_dtype=float, physics_dtype=float,
              overwrite=True, merge_if_possible=True):
        """Evaluate to a plain Model and write it; returns the Model."""
        self.evaluate_optically_thin_radii()
        m = self.to_model(merge_if_possible=merge_if_possible)
        m.write(filename=filename, compression=compression, copy=copy,
                absolute_paths=absolute_paths, wall_dtype=wall_dtype,
                physics_dtype=physics_dtype, overwrite=overwrite)
        self.filename = m.filename
        self._evaluated_model = m
        return m

    def run(self, *args, **kwargs):
        if getattr(self, "_evaluated_model", None) is None:
            raise Exception("Model has not been written yet - call write() "
                            "first")
        return self._evaluated_model.run(*args, **kwargs)
