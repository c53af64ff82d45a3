"""Luminosity sources: the 8 source types of the reference framework.

Parity target: hyperion/sources/source.py:38-1025 (base ``Source`` with
spectrum/temperature/LTE emission, and Point / PointCollection / Spherical
(+Spot) / ExternalSpherical / ExternalBox / Map / PlaneParallel sources).

Architecture differs from the reference: instead of hand-written property
pairs and per-class read/write methods, each source type declares a tuple of
``_Field`` records (attribute name, validator, ``.rtin`` encoding) and the
base class derives the Python properties, completeness checks, and HDF5
round-trip from that schema. The on-disk attribute/dataset names match the
reference's ``.rtin`` layout so model files stay interchangeable.
"""

import secrets

import numpy as np

from ..util.functions import (FreezableClass, is_numpy_array,
                              monotonically_increasing, bool2str, str2bool,
                              asstr, B_nu)
from ..util.hdf5_tables import read_table, write_table
from ..util.integrate import integrate_loglog
from ..util.interpolate import interp1d_fast_loglog
from ..util.validator import validate_scalar


def random_id(length=8):
    alphabet = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    return "".join(secrets.choice(alphabet) for _ in range(length))


# ---------------------------------------------------------------------------
# Validators (shared across field declarations)
# ---------------------------------------------------------------------------

def _positive_scalar(name, value):
    validate_scalar(name, value, domain='positive')


def _scalar_in(lo, hi):
    def check(name, value):
        validate_scalar(name, value, domain=[lo, hi])
    return check


def _fixed_length_seq(n):
    """Validator for an n-component coordinate-like sequence."""
    def check(name, value):
        if isinstance(value, (tuple, list)):
            ok = len(value) == n
        elif is_numpy_array(value):
            ok = value.ndim == 1 and len(value) == n
            if not ok:
                raise ValueError(
                    "%s should be a 1-D sequence of %d values" % (name, n))
        else:
            raise ValueError(
                "%s should be a tuple, list, or array" % name)
        if not ok:
            raise ValueError(
                "%s should be a sequence of %d values" % (name, n))
    return check


def _bounds_3x2(name, value):
    if isinstance(value, (tuple, list)):
        if np.shape(value) != (3, 2):
            raise ValueError(
                "%s should be a sequence of 3 pairs of values" % name)
    elif is_numpy_array(value):
        if value.ndim != 2 or value.shape != (3, 2):
            raise ValueError("%s should be a 3x2 array" % name)
    else:
        raise ValueError("%s should be a tuple, list, or array" % name)


# ---------------------------------------------------------------------------
# Field schema machinery
# ---------------------------------------------------------------------------

class _Field(object):
    """One validated source attribute and its ``.rtin`` encoding.

    ``attrs`` maps the value's components onto HDF5 attribute names (a single
    name for scalars, one per component for coordinate tuples). ``dataset``
    stores the value as an HDF5 dataset instead.
    """

    def __init__(self, name, doc, validate=None, default=None,
                 attrs=None, dataset=None, compression='gzip'):
        self.name = name
        self.doc = doc
        self.validate = validate
        self.default = default
        self.attrs = (attrs,) if isinstance(attrs, str) else attrs
        self.dataset = dataset
        self.compression = compression

    # -- python attribute surface --

    def make_property(self):
        slot = '_' + self.name
        field = self

        def fget(obj):
            return getattr(obj, slot)

        def fset(obj, value):
            if value is not None and field.validate is not None:
                field.validate(field.name, value)
            setattr(obj, slot, value)

        return property(fget, fset, doc=self.doc)

    # -- .rtin encoding --

    def store(self, group, value):
        if self.dataset is not None:
            group.create_dataset(self.dataset, data=np.asarray(value),
                                 compression=self.compression)
        elif len(self.attrs) == 1:
            group.attrs[self.attrs[0]] = value
        else:
            for key, component in zip(self.attrs, value):
                group.attrs[key] = component

    def load(self, group):
        if self.dataset is not None:
            return np.array(group[self.dataset])
        if len(self.attrs) == 1:
            return group.attrs[self.attrs[0]]
        return tuple(group.attrs[key] for key in self.attrs)


def _install_schema(cls):
    """Attach properties for every declared field of ``cls``."""
    for field in cls._fields:
        setattr(cls, field.name, field.make_property())
    return cls


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------

class Source(FreezableClass):
    """Base class for all source types.

    A source carries a bolometric luminosity and one of three emission
    spectra: a tabulated (nu, fnu) spectrum, a blackbody at ``temperature``,
    or — when neither is set — the local dust emissivity (LTE).
    """

    type_id = None          # .rtin 'type' attribute value
    _fields = ()            # subclass schema
    lte_allowed = False     # only MapSource may emit with the local emissivity

    def __init__(self, name=None, peeloff=True, **kwargs):
        self.name = name if name else random_id(length=8)
        self.peeloff = peeloff
        self.luminosity = None
        self.spectrum = None
        self.temperature = None
        for field in self._fields:
            setattr(self, field.name, field.default)
        self._freeze()
        for key, value in kwargs.items():
            setattr(self, key, value)

    # -- core attributes ------------------------------------------------------

    @property
    def luminosity(self):
        """Bolometric luminosity (erg/s)."""
        return self._luminosity

    @luminosity.setter
    def luminosity(self, value):
        if value is not None:
            validate_scalar('luminosity', value, domain='positive')
        self._luminosity = value

    @property
    def temperature(self):
        """Blackbody temperature (K)."""
        return self._temperature

    @temperature.setter
    def temperature(self, value):
        if value is not None:
            if getattr(self, '_spectrum', None) is not None:
                raise Exception("A spectrum has already been set, so cannot "
                                "set a temperature")
            validate_scalar('temperature', value, domain='positive')
        self._temperature = value

    @property
    def spectrum(self):
        """Tabulated spectrum, set as a (nu, fnu) pair (nu in Hz ascending)."""
        return self._spectrum

    @spectrum.setter
    def spectrum(self, value):
        if value is None:
            self._spectrum = None
            return
        if getattr(self, '_temperature', None) is not None:
            raise Exception("A temperature has already been set, so cannot "
                            "set a spectrum")
        nu, fnu = self._coerce_spectrum(value)
        self._spectrum = {'nu': nu, 'fnu': fnu}

    @staticmethod
    def _coerce_spectrum(value):
        if isinstance(value, dict):
            try:
                nu, fnu = value['nu'], value['fnu']
            except KeyError as exc:
                raise TypeError("spectrum dict needs 'nu' and 'fnu'") from exc
        elif isinstance(value, (tuple, list)):
            if len(value) != 2:
                raise TypeError(
                    "spectrum tuple or list should contain two elements")
            nu, fnu = value
        else:
            raise TypeError("spectrum should be specified as a (nu, fnu) "
                            "pair of 1-D arrays")
        nu = np.asarray(nu, dtype=float)
        fnu = np.asarray(fnu, dtype=float)
        if nu.ndim != 1 or fnu.ndim != 1:
            raise TypeError("nu and fnu should be 1-D sequences")
        if nu.shape != fnu.shape:
            raise TypeError("nu and fnu should have the same shape")
        if np.unique(nu).size != nu.size:
            raise ValueError("nu sequence contains duplicate values")
        if (nu <= 0.0).any():
            raise ValueError("nu should be strictly positive")
        if (fnu < 0.0).any():
            raise ValueError("fnu should be positive")
        if not (np.isfinite(nu).all() and np.isfinite(fnu).all()):
            raise ValueError("nu/fnu contains NaN/Inf values")
        if not monotonically_increasing(nu):
            order = np.argsort(nu)
            nu, fnu = nu[order], fnu[order]
        return nu, fnu

    # -- derived spectra ------------------------------------------------------

    def has_lte_spectrum(self):
        return self.spectrum is None and self.temperature is None

    def get_spectrum(self, nu_range=None):
        """Return (nu, fnu) scaled so ∫ fnu dnu equals the luminosity.

        For tabulated spectra ``nu_range`` crops (with exact interpolated
        endpoints) before normalizing; the reference raises
        NotImplementedError for this case (sources/source.py:227-229) — we
        support it.
        """
        self._check_all_set()
        if self.spectrum is not None:
            nu, fnu = self.spectrum['nu'], self.spectrum['fnu']
            if nu_range is not None:
                nu, fnu = _crop_spectrum(nu, fnu, *nu_range)
        elif self.temperature is not None:
            if nu_range is None:
                raise ValueError(
                    "nu_range is needed for sources with Planck spectra")
            nu = np.logspace(*np.log10(nu_range), num=50)
            nu[0], nu[-1] = nu_range  # undo log/exp roundoff at the ends
            fnu = B_nu(nu, self.temperature)
        else:
            raise Exception("Cannot compute spectrum for LTE emission sources")
        return nu, fnu * (self.luminosity / integrate_loglog(nu, fnu))

    # -- completeness ---------------------------------------------------------

    def _check_all_set(self):
        if self.luminosity is None:
            raise ValueError("luminosity is not set")
        for field in self._fields:
            if getattr(self, field.name) is None:
                suffix = "are not set" if field.name == "bounds" else "is not set"
                raise ValueError("%s %s" % (field.name, suffix))
        if self.has_lte_spectrum() and not self.lte_allowed:
            raise ValueError("%s cannot have LTE spectrum" % self._human_name())

    @classmethod
    def _human_name(cls):
        # 'ExternalBoxSource' -> 'External box source'
        words, word = [], ""
        for ch in cls.__name__:
            if ch.isupper() and word:
                words.append(word)
                word = ch.lower()
            else:
                word += ch.lower() if not word else ch.lower()
        words.append(word)
        text = " ".join(words)
        return text[0].upper() + text[1:]

    # -- shared .rtin encoding --------------------------------------------------

    def _encode_luminosity(self, group):
        group.attrs['luminosity'] = self.luminosity

    def _decode_luminosity(self, group):
        self.luminosity = group.attrs['luminosity']

    def _write_base(self, group):
        self._check_all_set()
        self._encode_luminosity(group)
        group.attrs['name'] = np.bytes_(self.name.encode('utf-8'))
        group.attrs['peeloff'] = bool2str(self.peeloff)
        if self.spectrum is not None:
            group.attrs['spectrum'] = np.bytes_('spectrum')
            write_table(group, 'spectrum', {'nu': self.spectrum['nu'],
                                            'fnu': self.spectrum['fnu']})
        elif self.temperature is not None:
            group.attrs['spectrum'] = np.bytes_('temperature')
            group.attrs['temperature'] = self.temperature
        else:
            group.attrs['spectrum'] = np.bytes_('lte')

    def _read_base(self, group):
        self.name = asstr(group.attrs['name'])
        self._decode_luminosity(group)
        self.peeloff = str2bool(group.attrs['peeloff'])
        kind = asstr(group.attrs['spectrum'])
        if kind == 'spectrum':
            table = read_table(group, 'spectrum')
            self.spectrum = (table['nu'], table['fnu'])
        elif kind == 'temperature':
            self.temperature = group.attrs['temperature']
        elif kind != 'lte':
            raise ValueError('Unexpected value for `spectrum`: %s' % kind)

    def write(self, handle, name):
        group = handle.create_group(name)
        self._write_base(group)
        group.attrs['type'] = np.bytes_(self.type_id)
        for field in self._fields:
            field.store(group, getattr(self, field.name))

    @classmethod
    def read(cls, handle):
        if asstr(handle.attrs['type']) != cls.type_id:
            raise ValueError("Source is not a %s" % cls.__name__)
        source = cls()
        source._read_base(handle)
        for field in cls._fields:
            setattr(source, field.name, field.load(handle))
        return source


def _crop_spectrum(nu, fnu, nu_min, nu_max):
    """Restrict a tabulated spectrum to [nu_min, nu_max] with interpolated
    endpoint samples so the band-limited integral is exact."""
    if nu_min >= nu_max:
        raise ValueError("nu_range should be increasing")
    inside = (nu > nu_min) & (nu < nu_max)
    lo = interp1d_fast_loglog(nu, fnu, np.array([max(nu_min, nu[0])]))
    hi = interp1d_fast_loglog(nu, fnu, np.array([min(nu_max, nu[-1])]))
    nu_out = np.concatenate(([max(nu_min, nu[0])], nu[inside],
                             [min(nu_max, nu[-1])]))
    fnu_out = np.concatenate((lo, fnu[inside], hi))
    keep = np.concatenate(([True], np.diff(nu_out) > 0))
    return nu_out[keep], fnu_out[keep]


# ---------------------------------------------------------------------------
# Concrete source types
# ---------------------------------------------------------------------------

_POSITION = _Field('position', "Cartesian position (x, y, z) in cm.",
                   validate=_fixed_length_seq(3),
                   default=(0.0, 0.0, 0.0), attrs=('x', 'y', 'z'))
_RADIUS = _Field('radius', "Radius (cm).", validate=_positive_scalar,
                 attrs='r')


@_install_schema
class PointSource(Source):
    """Isotropic point source at ``position`` (ref type 'point')."""

    type_id = 'point'
    _fields = (_POSITION,)


@_install_schema
class SpotSource(Source):
    """A hot spot on a spherical source (ref type 'spot')."""

    type_id = 'spot'
    _fields = (
        _Field('longitude', "Longitude of the spot (degrees).",
               validate=_scalar_in(0, 360), attrs='longitude'),
        _Field('latitude', "Latitude of the spot (degrees).",
               validate=_scalar_in(-90, 90), attrs='latitude'),
        _Field('radius', "Angular radius of the spot (degrees).",
               validate=_positive_scalar, attrs='radius'),
    )


def _limb_check(name, value):
    if not isinstance(value, bool):
        raise ValueError("limb should be a boolean value (True/False)")


class _LimbField(_Field):
    def store(self, group, value):
        group.attrs['limb'] = bool2str(value)

    def load(self, group):
        return str2bool(group.attrs['limb'])


@_install_schema
class SphericalSource(Source):
    """Sphere with optional limb darkening and spots (ref type 'sphere')."""

    type_id = 'sphere'
    _fields = (
        _POSITION,
        _RADIUS,
        _LimbField('limb', "Whether to include limb darkening.",
                   validate=_limb_check, default=False),
    )

    def __init__(self, name=None, peeloff=True, **kwargs):
        self.spots = []  # before Source.__init__ freezes the attribute set
        Source.__init__(self, name=name, peeloff=peeloff, **kwargs)

    def add_spot(self, *args, **kwargs):
        """Add a ``SpotSource`` on this sphere."""
        spot = SpotSource(*args, **kwargs)
        self.spots.append(spot)
        return spot

    def write(self, handle, name):
        Source.write(self, handle, name)
        group = handle[name]
        for index, spot in enumerate(self.spots):
            spot.write(group, 'Spot %i' % index)

    @classmethod
    def read(cls, handle):
        source = super(SphericalSource, cls).read(handle)
        for key in handle:
            if 'Spot' in key:
                source.spots.append(SpotSource.read(handle[key]))
        return source


@_install_schema
class ExternalSphericalSource(Source):
    """Inward-emitting sphere modelling an external radiation field
    (ref type 'extern_sph')."""

    type_id = 'extern_sph'
    _fields = (_POSITION, _RADIUS)


@_install_schema
class ExternalBoxSource(Source):
    """Inward-emitting box modelling an external radiation field
    (ref type 'extern_box')."""

    type_id = 'extern_box'
    _fields = (
        _Field('bounds',
               "Bounds [[xmin, xmax], [ymin, ymax], [zmin, zmax]] in cm.",
               validate=_bounds_3x2,
               attrs=('xmin', 'xmax', 'ymin', 'ymax', 'zmin', 'zmax')),
    )

    # bounds are a 3x2 nested sequence; flatten/unflatten around the generic
    # component encoding
    def write(self, handle, name):
        group = handle.create_group(name)
        self._write_base(group)
        group.attrs['type'] = np.bytes_(self.type_id)
        flat = np.asarray(self.bounds).ravel()
        for key, component in zip(self._fields[0].attrs, flat):
            group.attrs[key] = component

    @classmethod
    def read(cls, handle):
        if asstr(handle.attrs['type']) != cls.type_id:
            raise ValueError("Source is not a %s" % cls.__name__)
        source = cls()
        source._read_base(handle)
        a = handle.attrs
        source.bounds = [(a['xmin'], a['xmax']),
                         (a['ymin'], a['ymax']),
                         (a['zmin'], a['zmax'])]
        return source


@_install_schema
class PlaneParallelSource(Source):
    """Circular beam emitting in one direction (ref type 'plane_parallel')."""

    type_id = 'plane_parallel'
    _fields = (
        _POSITION,
        _Field('radius', "Radius of the beam (cm).",
               validate=_positive_scalar, attrs='r'),
        _Field('direction', "Direction of emission as (theta, phi) in degrees.",
               validate=_fixed_length_seq(2),
               attrs=('theta', 'phi')),
    )

    def __init__(self, name=None, peeloff=False, **kwargs):
        Source.__init__(self, name=name, peeloff=peeloff, **kwargs)


class PointSourceCollection(Source):
    """N point sources sharing a spectrum; luminosity is an (N,) array and
    position an (N, 3) array (ref type 'point_collection')."""

    type_id = 'point_collection'

    def __init__(self, name=None, peeloff=True, **kwargs):
        self._position = None
        Source.__init__(self, name=name, peeloff=peeloff, **kwargs)

    @property
    def luminosity(self):
        """Luminosity array (N,) in erg/s."""
        return self._luminosity

    @luminosity.setter
    def luminosity(self, value):
        if value is not None:
            if not is_numpy_array(value):
                raise ValueError("luminosity should be a Numpy array")
            if value.ndim != 1:
                raise ValueError("luminosity should be a 1-D array")
            if not (value > 0.0).all():
                raise ValueError("luminosity should be positive")
            pos = getattr(self, '_position', None)
            if pos is not None and value.shape[0] != pos.shape[0]:
                raise ValueError("luminosity should be a 1-D array with the "
                                 "same number of rows as position")
        self._luminosity = value

    @property
    def position(self):
        """Positions (N, 3) in cm."""
        return self._position

    @position.setter
    def position(self, value):
        if value is not None:
            if not is_numpy_array(value):
                raise ValueError("position should be a Numpy array")
            if value.ndim != 2 or value.shape[1] != 3:
                raise ValueError("position should be a 2-D array with 3 columns")
            lum = getattr(self, '_luminosity', None)
            if lum is not None and value.shape[0] != lum.shape[0]:
                raise ValueError("position should be a 2-D array with the "
                                 "same number of rows as luminosity")
        self._position = value

    def _check_all_set(self):
        Source._check_all_set(self)
        if self.position is None:
            raise ValueError("position is not set")
        if self.has_lte_spectrum():
            raise ValueError("Point source collection cannot have LTE spectrum")

    def _encode_luminosity(self, group):
        group.create_dataset('luminosity', data=self.luminosity,
                             compression='gzip')

    def _decode_luminosity(self, group):
        self.luminosity = np.array(group['luminosity'])

    def write(self, handle, name):
        group = handle.create_group(name)
        self._write_base(group)
        group.attrs['type'] = np.bytes_(self.type_id)
        group.create_dataset('position', data=self.position,
                             compression='gzip')

    @classmethod
    def read(cls, handle):
        if asstr(handle.attrs['type']) != cls.type_id:
            raise ValueError("Source is not a PointSourceCollection")
        source = cls()
        source._read_base(handle)
        source.position = np.array(handle['position'])
        return source


def _map_check(name, value):
    if not is_numpy_array(value):
        raise ValueError("map should be a Numpy array")
    if not value.any():
        raise ValueError("Luminosity map is zero everywhere")


@_install_schema
class MapSource(Source):
    """Diffuse source with per-cell relative luminosities (ref type 'map')."""

    type_id = 'map'
    lte_allowed = True
    _fields = (
        _Field('map', "Relative luminosity per cell (grid-shaped array).",
               validate=_map_check, dataset='Luminosity map'),
    )

    def write(self, handle, name, grid=None, compression=True,
              map_dtype=float):
        group = handle.create_group(name)
        self._write_base(group)
        group.attrs['type'] = np.bytes_(self.type_id)
        if grid is not None:
            grid.write_single_array(group, 'Luminosity map', self.map,
                                    compression=compression,
                                    physics_dtype=map_dtype)
        else:
            group.create_dataset(
                'Luminosity map', data=self.map,
                compression='gzip' if compression else None)


_SOURCE_TYPES = {cls.type_id: cls for cls in
                 (PointSource, PointSourceCollection, SpotSource,
                  SphericalSource, ExternalSphericalSource, ExternalBoxSource,
                  MapSource, PlaneParallelSource)}


def read_source(handle):
    kind = asstr(handle.attrs['type'])
    try:
        return _SOURCE_TYPES[kind].read(handle)
    except KeyError:
        raise ValueError("Unexpected source type: {0}".format(kind))
