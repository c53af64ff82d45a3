"""Spectral transmission filters for convolved imaging.

Functional parity with hyperion/filter/filter.py (ours takes plain Hz arrays
instead of astropy Quantities, which are not available in this environment).
The on-disk table (columns nu/tr/tn + attrs name/alpha/beta/nu0) matches the
reference ``.rtin`` schema.

The normalization convention: the engine bins photon energy weighted by
``tn(nu)``, and the result is quoted as nu0*Fnu(nu0) calibrated against a
reference spectral shape Fnu ~ nu^alpha with a detector response
nu^beta (beta = -1 for energy-counting, 0 for photon-counting detectors).
"""

import numpy as np

from ..util.integrate import integrate
from ..util.validator import validate_scalar, validate_array
from ..util.functions import asstr

_BETA = {'energy': -1, 'photons': 0}


def normalize_response(nu, tr, nu0, alpha, beta):
    """The tn column: tr reweighted so that binned energy comes out as
    nu0*Fnu(nu0) for a nu^alpha reference spectrum (ref filter.py:105-115)."""
    order = np.argsort(nu)
    nu, tr = nu[order], tr[order]
    calib = nu0 ** alpha * integrate(nu, tr / nu ** (1.0 + alpha + beta))
    return nu, tr, tr * nu / (nu ** (1 + beta) * calib)


class Filter(object):
    """A named spectral transmission curve.

    Attributes: ``nu`` (Hz), ``transmission`` (0-1), ``central_nu`` (the
    quoted frequency, Hz), ``alpha`` (reference spectral index) and
    ``detector_type`` ('energy' or 'photons').
    """

    def __init__(self, name=None, nu=None, transmission=None):
        self._beta = None
        self._alpha = None
        self._central_nu = None
        self.name = name
        self.nu = nu
        self.transmission = transmission

    # -- validated attributes --------------------------------------------------

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, value):
        if not (value is None or isinstance(value, str)):
            raise TypeError("name should be given as a string")
        self._name = value

    @property
    def nu(self):
        return self._nu

    @nu.setter
    def nu(self, value):
        self._nu = None if value is None else validate_array(
            'nu', np.asarray(value, float), domain='strictly-positive',
            ndim=1)

    @property
    def transmission(self):
        return self._transmission

    @transmission.setter
    def transmission(self, value):
        shape = None if self.nu is None else (len(self.nu),)
        self._transmission = None if value is None else validate_array(
            'transmission', np.asarray(value, float), domain='positive',
            ndim=1, shape=shape)

    @property
    def central_nu(self):
        return self._central_nu

    @central_nu.setter
    def central_nu(self, value):
        if value is not None:
            validate_scalar('central_nu', value, domain='strictly-positive')
        self._central_nu = value

    @property
    def alpha(self):
        """Exponent of the nu^alpha reference spectral shape."""
        return self._alpha

    @alpha.setter
    def alpha(self, value):
        self._alpha = value

    @property
    def detector_type(self):
        """'energy' or 'photons' — sets the beta normalization exponent."""
        for kind, beta in _BETA.items():
            if beta == self._beta:
                return kind
        return None

    @detector_type.setter
    def detector_type(self, value):
        try:
            self._beta = _BETA[value]
        except KeyError:
            raise ValueError("detector_type should be one of energy/photons")

    def check_all_set(self):
        for attr in ('nu', 'transmission', 'name', 'alpha', 'detector_type',
                     'central_nu'):
            if getattr(self, attr) is None:
                raise ValueError("{0} has not been set".format(attr))

    @property
    def normalized_response(self):
        """(nu, tn): the engine-side response table."""
        nu, _, tn = normalize_response(self.nu, self.transmission,
                                       self.central_nu, self._alpha,
                                       self._beta)
        return nu, tn

    # -- .rtin encoding ---------------------------------------------------------

    def to_hdf5_group(self, group, name):
        self.check_all_set()
        nu, tr, tn = normalize_response(self.nu, self.transmission,
                                        self.central_nu, self._alpha,
                                        self._beta)
        table = np.empty(nu.size, dtype=[('nu', float), ('tr', float),
                                         ('tn', float)])
        table['nu'], table['tr'], table['tn'] = nu, tr, tn
        dset = group.create_dataset(name, data=table)
        dset.attrs['name'] = np.bytes_(self.name)
        dset.attrs['alpha'] = self.alpha
        dset.attrs['beta'] = self._beta
        dset.attrs['nu0'] = self.central_nu

    @classmethod
    def from_hdf5_group(cls, group, name):
        dset = group[name]
        self = cls(name=asstr(dset.attrs['name']),
                   nu=np.array(dset['nu']),
                   transmission=np.array(dset['tr']))
        self.alpha = dset.attrs['alpha']
        self._beta = dset.attrs['beta']
        self.central_nu = float(dset.attrs['nu0'])
        return self
