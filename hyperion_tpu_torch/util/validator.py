"""Scalar/array argument validators (ref: hyperion/util/validator.py, minus
the astropy Quantity paths — plain floats/arrays only)."""

import numpy as np


def validate_scalar(name, value, domain=None, extra=''):
    if not np.isscalar(value):
        raise ValueError("{0} should be a scalar value{1}".format(name, extra))
    if not np.isreal(value):
        raise ValueError("{0} should be a numerical value{1}".format(name, extra))
    if domain == 'positive':
        if value < 0.0:
            raise ValueError("{0} should be positive".format(name))
    elif domain == 'strictly-positive':
        if value <= 0.0:
            raise ValueError("{0} should be strictly positive".format(name))
    elif domain == 'negative':
        if value > 0.0:
            raise ValueError("{0} should be negative".format(name))
    elif domain == 'strictly-negative':
        if value >= 0.0:
            raise ValueError("{0} should be strictly negative".format(name))
    elif type(domain) in [tuple, list] and len(domain) == 2:
        if value < domain[0] or value > domain[-1]:
            raise ValueError("{0} should be in the range [{1}:{2}]"
                             .format(name, domain[0], domain[-1]))
    return value


def validate_array(name, value, domain=None, ndim=1, shape=None):
    if type(value) in [list, tuple]:
        value = np.array(value)
    if not isinstance(value, np.ndarray) or value.ndim != ndim:
        if ndim == 1:
            raise TypeError("{0} should be a 1-d sequence".format(name))
        raise TypeError("{0} should be a {1:d}-d array".format(name, ndim))
    if shape is not None and value.shape != shape:
        if ndim == 1:
            raise ValueError("{0} has incorrect length (expected {1} but found {2})"
                             .format(name, shape[0], value.shape[0]))
        raise ValueError("{0} has incorrect shape (expected {1} but found {2})"
                         .format(name, shape, value.shape))
    return value
