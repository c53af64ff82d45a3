from . import constants  # noqa: F401
from .functions import FreezableClass, B_nu, dB_nu_dT, planck_nu_range, nu_common  # noqa: F401
