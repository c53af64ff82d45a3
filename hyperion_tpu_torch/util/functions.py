"""Small shared utilities: attribute-locked classes, Planck functions,
frequency-grid helpers.

Behavioural parity targets (ref: hyperion/util/functions.py): ``FreezableClass``
(:85-108), ``B_nu`` (:190-201), ``dB_nu_dT`` (:203-215), ``planck_nu_range``
(:112-135), ``nu_common`` (:137-150).
"""

import numpy as np

from .constants import c, h, k

MAX_EXP = 700.0  # exp() overflow guard in double precision


class FreezableClass(object):
    """Base class whose attribute set can be frozen.

    After ``self._freeze()`` is called, assigning to an attribute that does not
    already exist raises ``AttributeError`` — catching typos in user scripts.
    ``self._finalize()`` makes the instance fully immutable.
    """

    _frozen = False
    _final = False

    def _freeze(self):
        object.__setattr__(self, '_frozen', True)

    def _finalize(self):
        object.__setattr__(self, '_final', True)

    @classmethod
    def isfrozen(cls):
        return cls._frozen

    def isfinal(self):
        return self._final

    def __setattr__(self, key, value):
        if self._final:
            raise Exception("Attribute %s can no longer be changed" % key)
        # existence check must not INVOKE instance getters: derived
        # properties (e.g. a disk's rho_0 computed from mass) may
        # legitimately raise while the object is half-configured
        if self._frozen and not (key in self.__dict__
                                 or hasattr(type(self), key)):
            raise AttributeError("Attribute %s does not exist" % key)
        object.__setattr__(self, key, value)


def is_numpy_array(x):
    return isinstance(x, np.ndarray)


def monotonically_increasing(x):
    return np.all(np.diff(x) > 0.0)


def bool2str(value):
    return np.bytes_(b'yes') if value else np.bytes_(b'no')


def str2bool(value):
    if isinstance(value, bytes):
        value = value.decode('utf-8')
    return value.lower() == 'yes'


def asstr(value):
    if isinstance(value, bytes):
        return value.decode('utf-8')
    return str(value)


def B_nu(nu, T):
    """Planck function B_nu(T) in erg/cm^2/s/Hz/sr; vectorized over nu.

    Uses a series expansion for small h*nu/k/T to avoid catastrophic
    cancellation, mirroring the reference's treatment.
    """
    nu = np.asarray(nu, dtype=float)
    x = h * nu / (k * T)
    pref = 2.0 * h * nu ** 3 / c ** 2
    with np.errstate(over='ignore', divide='ignore', invalid='ignore'):
        main = pref / np.expm1(np.minimum(x, MAX_EXP))
        small = pref / x
    out = np.where(x < 1.e-8, small, main)
    out = np.where(x >= MAX_EXP, 0.0, out)
    return out


def dB_nu_dT(nu, T):
    """Derivative of the Planck function with respect to temperature."""
    nu = np.asarray(nu, dtype=float)
    b = B_nu(nu, T)
    x = h * nu / (k * T)
    with np.errstate(over='ignore', divide='ignore', invalid='ignore'):
        main = x / T / (-np.expm1(-x)) * b
    out = np.where(x < 1.e-14, b / T, main)
    return out


def planck_nu_range(tmin, tmax=None):
    """Frequency grid spanning the Planck functions of tmin..tmax.

    Extends two decades below the Wien peak of tmin and one decade above the
    peak of tmax, with 100 points per decade.
    """
    alpha = 2.821439  # Wien displacement constant for B_nu
    nu_peak_min = alpha / h * k * tmin
    nu_peak_max = alpha / h * k * (tmin if tmax is None else tmax)
    nu_min = np.log10(nu_peak_min / 100.0)
    nu_max = np.log10(nu_peak_max * 10.0)
    n_nu = int((nu_max - nu_min) * 100.0)
    return np.logspace(nu_min, nu_max, n_nu)


def nu_common(nu1, nu2):
    """Merge two frequency grids, dropping near-duplicate values."""
    nu = np.sort(np.hstack([nu1, nu2]))
    keep = (nu[1:] - nu[:-1]) / nu[:-1] > 1.e-10
    keep = np.hstack([keep, True])
    return nu[keep]
