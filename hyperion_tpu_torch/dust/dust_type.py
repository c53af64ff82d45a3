"""Dust model container: optical properties + mean opacities + emissivities.

Parity target: the reference's ``SphericalDust`` family and its HDF5 dust-file
format version 2 (ref: hyperion/dust/dust_type.py:43-760). A dust file holds
the optical-properties tables, mean-opacity tables, emissivity tables and
sublimation attributes; ``temperature2specific_energy`` and its inverse are
log-log interpolations along the mean-opacity table.
"""

import hashlib
import os

import numpy as np

from ..util.constants import c, sigma
from ..util.functions import FreezableClass, asstr
from ..util.integrate import integrate_loglog
from ..util.interpolate import interp1d_fast_loglog
from .optical_properties import OpticalProperties
from .mean_opacities import MeanOpacities
from .emissivities import Emissivities

from .. import __version__


def henyey_greenstein(mu, g, p_lin_max):
    """Henyey-Greenstein (1941) phase function matrix elements at cos(theta)=mu.

    Returns P1 (phase function), P2 (linear polarization, peaking at
    ``p_lin_max`` at 90 degrees), P3 (circular-transfer term), P4 (zero) for
    arrays ``g``/``p_lin_max`` over frequency.
    """
    P1 = (1.0 - g ** 2) / (1.0 + g ** 2 - 2.0 * g * mu) ** 1.5
    P2 = -p_lin_max * P1 * (1.0 - mu ** 2) / (1.0 + mu ** 2)
    P3 = P1 * 2.0 * mu / (1.0 + mu ** 2)
    P4 = np.zeros_like(P1)
    return P1, P2, P3, P4


class SphericalDust(FreezableClass):
    """A dust population with angle-averaged (spherical-grain) properties."""

    def __init__(self, *args):

        self.optical_properties = OpticalProperties()
        self.mean_opacities = MeanOpacities()
        self.emissivities = Emissivities()

        self.md5 = None
        self._file = None

        self.sublimation_mode = 'no'
        self.sublimation_energy = 0.0

        self._freeze()

        if len(args) == 0:
            pass
        elif len(args) == 1:
            self.read(args[0])
        else:
            raise Exception("SphericalDust cannot take more than one argument")

    # -- hashing (used for density-grid merging decisions) --------------------

    def hash(self):
        h = hashlib.md5()
        self.optical_properties.hash_update(h)
        self.mean_opacities.hash_update(h)
        self.emissivities.hash_update(h)
        h.update(self.sublimation_mode.encode('utf-8'))
        h.update(np.float64(self.sublimation_energy).tobytes())
        return h.hexdigest()

    # -- sublimation -----------------------------------------------------------

    def set_sublimation_temperature(self, mode, temperature=0.0):
        """Set sublimation mode ('no'/'fast'/'slow'/'cap') and temperature (K)."""
        if mode not in ['no', 'fast', 'slow', 'cap']:
            raise Exception("mode should be one of no/fast/slow/cap")
        self.sublimation_mode = mode
        if mode != 'no':
            self.sublimation_energy = float(
                self.temperature2specific_energy(temperature))

    def set_sublimation_specific_energy(self, mode, specific_energy=0.0):
        """Set sublimation mode and threshold specific energy (cgs)."""
        if mode not in ['no', 'fast', 'slow', 'cap']:
            raise Exception("mode should be one of no/fast/slow/cap")
        self.sublimation_mode = mode
        self.sublimation_energy = float(specific_energy)

    def _write_dust_sublimation(self, group):
        group.attrs['sublimation_mode'] = np.bytes_(self.sublimation_mode)
        if self.sublimation_mode in ['slow', 'fast', 'cap']:
            group.attrs['sublimation_specific_energy'] = self.sublimation_energy

    def _read_dust_sublimation(self, group):
        if 'sublimation_mode' in group.attrs:
            self.sublimation_mode = asstr(group.attrs['sublimation_mode'])
            if self.sublimation_mode in ['slow', 'fast', 'cap']:
                self.sublimation_energy = float(
                    group.attrs['sublimation_specific_energy'])

    # -- derived quantities ----------------------------------------------------

    def _compute_mean_opacities(self):
        if not self.mean_opacities.all_set():
            self.mean_opacities.compute(self.optical_properties)

    def set_lte_emissivities(self, n_temp=1200, temp_min=0.1,
                             temp_max=100000.):
        """Tabulate LTE emissivities over an explicit temperature grid
        (ref dust_type.py:105-135): recomputes the mean opacities on
        (n_temp, temp_min, temp_max) and sets j_nu = kappa_nu B_nu(T)."""
        self.mean_opacities.compute(self.optical_properties, n_temp=n_temp,
                                    temp_min=temp_min, temp_max=temp_max)
        self.emissivities.set_lte(self.optical_properties,
                                  self.mean_opacities)

    def chi_nu_temperature(self, temperature):
        """Planck-mean extinction opacity for a blackbody at ``temperature``."""
        self._compute_mean_opacities()
        return interp1d_fast_loglog(self.mean_opacities.temperature,
                                    self.mean_opacities.chi_planck, temperature)

    def kappa_nu_temperature(self, temperature):
        """Planck-mean absorption opacity for a blackbody at ``temperature``."""
        self._compute_mean_opacities()
        return interp1d_fast_loglog(self.mean_opacities.temperature,
                                    self.mean_opacities.kappa_planck, temperature)

    def chi_nu_spectrum(self, nu, fnu):
        """Spectrum-weighted mean extinction opacity."""
        self.optical_properties.ensure_all_set()
        if nu.min() < self.optical_properties.nu.min() or \
           nu.max() > self.optical_properties.nu.max():
            raise Exception("Opacity to extinction is not defined at all "
                            "spectrum frequencies")
        chi_nu = self.optical_properties.interp_chi_nu(nu)
        return integrate_loglog(nu, fnu * chi_nu) / integrate_loglog(nu, fnu)

    def kappa_nu_spectrum(self, nu, fnu):
        """Spectrum-weighted mean absorption opacity."""
        self.optical_properties.ensure_all_set()
        if nu.min() < self.optical_properties.nu.min() or \
           nu.max() > self.optical_properties.nu.max():
            raise Exception("Opacity to absorption is not defined at all "
                            "spectrum frequencies")
        kappa_nu = self.optical_properties.interp_kappa_nu(nu)
        return integrate_loglog(nu, fnu * kappa_nu) / integrate_loglog(nu, fnu)

    def temperature2specific_energy(self, temperature):
        self._compute_mean_opacities()
        tt = self.mean_opacities.temperature
        ee = self.mean_opacities.specific_energy
        se = interp1d_fast_loglog(tt, ee, np.clip(temperature, tt[0], tt[-1]))
        return se

    def specific_energy2temperature(self, specific_energy):
        self._compute_mean_opacities()
        tt = self.mean_opacities.temperature
        ee = self.mean_opacities.specific_energy
        temp = interp1d_fast_loglog(ee, tt, np.clip(specific_energy, ee[0], ee[-1]))
        return temp

    # -- I/O ------------------------------------------------------------------

    def write(self, filename, compression=True):
        """Write a standard dust file (format version 2), computing mean
        opacities and LTE emissivities on demand."""
        import h5py

        self.optical_properties.ensure_all_set()
        self._compute_mean_opacities()
        if not self.emissivities.all_set():
            self.emissivities.set_lte(self.optical_properties,
                                      self.mean_opacities)

        if isinstance(filename, str):
            dt = h5py.File(filename, 'w')
        else:
            dt = filename

        dt.attrs['version'] = 2
        dt.attrs['type'] = 1
        dt.attrs['python_version'] = np.bytes_(__version__)
        if self.md5:
            dt.attrs['asciimd5'] = np.bytes_(self.md5)

        self.optical_properties.to_hdf5_group(dt, compression=compression)
        self.mean_opacities.to_hdf5_group(dt, compression=compression)
        self.emissivities.to_hdf5_group(dt, compression=compression)
        self._write_dust_sublimation(dt)

        if isinstance(dt, h5py.File):
            dt.close()
            self._file = (filename, self.hash())

    def read(self, filename):
        """Read a standard dust file (format version 1 or 2)."""
        import h5py

        if isinstance(filename, str):
            if not os.path.exists(filename):
                raise Exception("File not found: %s" % filename)
            dt = h5py.File(filename, 'r')
            close = True
        else:
            dt = filename
            close = False

        if dt.attrs['version'] not in [1, 2]:
            raise Exception("Version should be 1 or 2")
        if dt.attrs['type'] != 1:
            raise Exception("Type should be 1")
        self.md5 = asstr(dt.attrs['asciimd5']) if 'asciimd5' in dt.attrs else None

        self.optical_properties.from_hdf5_group(dt)
        if dt.attrs['version'] == 1:
            self.mean_opacities.compute(self.optical_properties)
        else:
            self.mean_opacities.from_hdf5_group(dt)
        self.emissivities.from_hdf5_group(dt)
        self._read_dust_sublimation(dt)

        if close:
            dt.close()
            self._file = (filename, self.hash())


class IsotropicDust(SphericalDust):
    """Isotropically scattering dust defined by (nu, albedo, chi) arrays."""

    def __init__(self, nu, albedo, chi):
        SphericalDust.__init__(self)
        op = self.optical_properties
        op.mu = np.linspace(-1.0, 1.0, 2)
        op.nu = np.asarray(nu, dtype=float)
        op.albedo = np.asarray(albedo, dtype=float)
        op.chi = np.asarray(chi, dtype=float)
        op.initialize_scattering_matrix()
        op.P1[:, :] = 1.0
        op.P2[:, :] = 0.0
        op.P3[:, :] = 1.0
        op.P4[:, :] = 0.0
        op._sort()


class HenyeyGreensteinDust(SphericalDust):
    """Dust with Henyey-Greenstein scattering defined by per-frequency
    asymmetry ``g`` and max linear polarization ``p_lin_max``."""

    def __init__(self, nu, albedo, chi, g, p_lin_max):
        SphericalDust.__init__(self)
        op = self.optical_properties
        n_mu = 100
        op.mu = np.linspace(-1.0, 1.0, n_mu)
        op.nu = np.asarray(nu, dtype=float)
        op.albedo = np.asarray(albedo, dtype=float)
        op.chi = np.asarray(chi, dtype=float)
        op.initialize_scattering_matrix()
        g = np.asarray(g, dtype=float)
        p_lin_max = np.asarray(p_lin_max, dtype=float)
        for i in range(n_mu):
            op.P1[:, i], op.P2[:, i], op.P3[:, i], op.P4[:, i] = \
                henyey_greenstein(op.mu[i], g, p_lin_max)
        op._sort()


class HOCHUNKDust(HenyeyGreensteinDust):
    """HG dust read from a HOCHUNK-format text file."""

    def __init__(self, filename):
        dustfile = np.loadtxt(
            filename, dtype=[('wav', float), ('c_ext', float), ('c_sca', float),
                             ('chi', float), ('g', float), ('p_lin_max', float)],
            usecols=[0, 1, 2, 3, 4, 5])
        if dustfile['wav'][-1] > dustfile['wav'][0]:
            dustfile = dustfile[::-1]
        nu = c / dustfile['wav'] * 1.e4
        albedo = dustfile['c_sca'] / dustfile['c_ext']
        md5 = hashlib.md5(open(filename, 'rb').read()).hexdigest()
        HenyeyGreensteinDust.__init__(self, nu, albedo, dustfile['chi'],
                                      dustfile['g'], dustfile['p_lin_max'])
        self.md5 = md5


TTsreDust = HOCHUNKDust


def _fill_scattering_matrix(op, rows):
    """Populate P1..P4 from an iterable of per-frequency (mu, s11, s12,
    s33, s34) records; the first record fixes the mu grid."""
    for i, (theta_deg, s11, s12, s33, s34) in enumerate(rows):
        if i == 0:
            op.mu = np.cos(np.radians(theta_deg))
            op.initialize_scattering_matrix()
        op.P1[i, :] = s11
        op.P2[i, :] = s12
        op.P3[i, :] = s33
        op.P4[i, :] = s34


class _CoatsphDust(SphericalDust):
    """Shared reader for the coated-sphere Mie code output (ref
    dust_type.py:624-729): a forward-scattering summary file plus one
    scattering-matrix file per wavelength."""

    _forw_skiprows = None
    _forw_dtype = None
    _scat_pattern = None
    _scat_skiprows = None

    def _load(self, directory):
        forw = os.path.join(directory, 'coatsph_forw.dat')
        with open(forw, 'rb') as fh:
            fh.readline()  # version banner
            fh.readline()  # component count line
            table = np.loadtxt(fh, skiprows=self._forw_skiprows,
                               dtype=self._forw_dtype)
        op = self.optical_properties
        op.nu = c / table['wav'] * 1.e4
        self._set_opacities(op, table)

        scat_dtype = [('theta', float), ('s11', float), ('polariz', float),
                      ('s12', float), ('s33', float), ('s34', float)]
        rows = []
        for i in range(len(table)):
            scat = np.loadtxt(os.path.join(directory, self._scat_pattern % (i + 1)),
                              skiprows=self._scat_skiprows, dtype=scat_dtype)
            rows.append((scat['theta'], scat['s11'], scat['s12'],
                         scat['s33'], scat['s34']))
        _fill_scattering_matrix(op, rows)
        return table


class CoatsphSingle(_CoatsphDust):
    """Single-component coated-sphere dust: opacity derived from Q_ext,
    grain ``size`` (cm) and material ``density`` (g/cm^3)."""

    _forw_skiprows = 3
    _forw_dtype = [('x', float), ('radius', float), ('wav', float),
                   ('q_ext', float), ('q_sca', float), ('q_back', float),
                   ('g', float)]
    _scat_pattern = 'coatsph_scat_%04i_0001.dat'
    _scat_skiprows = 9

    def __init__(self, directory, size, density):
        SphericalDust.__init__(self)
        self._size = size
        self._density = density
        self._load(directory)

    def _set_opacities(self, op, table):
        op.albedo = table['q_sca'] / table['q_ext']
        # chi = (3/4) Q_ext / (a rho): geometric cross-section per unit mass
        op.chi = 0.75 * table['q_ext'] / (self._size * self._density)


class CoatsphMultiple(_CoatsphDust):
    """Multi-component coated-sphere dust: opacities read directly from the
    size-distribution-averaged summary table."""

    _forw_skiprows = 7
    _forw_dtype = [('wav', float), ('c_ext', float), ('c_sca', float),
                   ('chi', float), ('g', float), ('pmax', float),
                   ('thetmax', float)]
    _scat_pattern = 'coatsph_scat.%04i.dat'
    _scat_skiprows = 7

    def __init__(self, directory):
        SphericalDust.__init__(self)
        self._load(directory)

    def _set_opacities(self, op, table):
        op.albedo = table['c_sca'] / table['c_ext']
        op.chi = table['chi']


def _interp_nan_loglog(wav, values):
    """Replace NaNs by log-log interpolation over wavelength (the MieX code
    emits NaN at wavelengths where a quantity underflows)."""
    bad = np.isnan(values)
    if not bad.any():
        return values
    good_wav, good_val = wav[~bad][::-1], values[~bad][::-1]
    values = values.copy()
    values[bad] = interp1d_fast_loglog(good_wav, good_val, wav[bad])
    if np.isnan(values).any():
        raise Exception("Did not manage to fix NaN values in MieX data")
    return values


class MieXDust(SphericalDust):
    """Dust computed with the MieX code: per-quantity text files named
    ``<model>.alb``, ``<model>.k_abs``, ``<model>.f11`` ... ``<model>.f34``.

    The matrix files interleave a wavelength line with n_mu angle rows; we
    parse them with a single loadtxt + reshape rather than per-line reads.
    """

    def __init__(self, model):
        SphericalDust.__init__(self)
        op = self.optical_properties

        wav, albedo = np.loadtxt('%s.alb' % model, usecols=[0, 1], unpack=True)
        kappa = np.loadtxt('%s.k_abs' % model, usecols=[1])
        albedo = _interp_nan_loglog(wav, albedo)
        chi = _interp_nan_loglog(wav, kappa / (1.0 - albedo))
        op.nu = c / wav * 1.e4
        op.albedo = albedo
        op.chi = chi

        theta, blocks = self._parse_blocks('%s.f11' % model, wav)
        n_mu = theta.size
        op.mu = np.cos(np.radians(theta))[::-1]
        op.initialize_scattering_matrix()
        op.P1[:, :] = blocks[:, ::-1]
        for key, attr in (('f12', 'P2'), ('f33', 'P3'), ('f34', 'P4')):
            _, blk = self._parse_blocks('%s.%s' % (model, key), wav)
            getattr(op, attr)[:, :] = blk[:, ::-1]
        for attr in ('P1', 'P2', 'P3', 'P4'):
            values = getattr(op, attr)
            for i in range(n_mu):
                values[:, i] = _interp_nan_loglog(wav, values[:, i])

    @staticmethod
    def _parse_blocks(path, wav):
        """Parse a MieX matrix file: header line, then per wavelength a
        wavelength line followed by (angle, value) rows. Returns the angle
        grid and an (n_wav, n_mu) value array."""
        with open(path) as fh:
            lines = [ln.split() for ln in fh if ln.strip()]
        lines = lines[1:]  # header
        n_wav = wav.size
        if len(lines) % n_wav:
            raise Exception("Unexpected MieX matrix file layout: %s" % path)
        per_block = len(lines) // n_wav
        n_mu = per_block - 1
        theta = np.array([float(lines[1 + i][0]) for i in range(n_mu)])
        values = np.empty((n_wav, n_mu))
        for j in range(n_wav):
            block = lines[j * per_block:(j + 1) * per_block]
            if abs(float(block[0][0]) - wav[j]) > 1e-5 * abs(wav[j]):
                raise Exception("Incorrect wavelength in %s" % path)
            values[j, :] = [float(row[1]) for row in block[1:]]
        return theta, values


class BHDust(SphericalDust):
    """Dust from the bhmie wrapper (output format 2): whitespace tables
    ``<model>.wav/.mu/.alb/.chi/.f11/.f12/.f33/.f34``."""

    def __init__(self, model):
        SphericalDust.__init__(self)
        op = self.optical_properties

        mu = np.loadtxt('%s.mu' % model)
        nu = c / np.loadtxt('%s.wav' % model) * 1.e4
        albedo = np.loadtxt('%s.alb' % model)
        chi = np.loadtxt('%s.chi' % model)
        P = {key: np.atleast_2d(np.loadtxt('%s.%s' % (model, key)))
             for key in ('f11', 'f12', 'f33', 'f34')}

        nu_order = slice(None) if nu[-1] >= nu[0] else slice(None, None, -1)
        mu_order = slice(None) if mu[-1] >= mu[0] else slice(None, None, -1)
        op.nu = nu[nu_order]
        op.albedo = albedo[nu_order]
        op.chi = chi[nu_order]
        op.mu = mu[mu_order]
        op.P1 = P['f11'][nu_order, mu_order]
        op.P2 = P['f12'][nu_order, mu_order]
        op.P3 = P['f33'][nu_order, mu_order]
        op.P4 = P['f34'][nu_order, mu_order]
