from .optical_properties import OpticalProperties  # noqa: F401
from .mean_opacities import MeanOpacities  # noqa: F401
from .emissivities import Emissivities  # noqa: F401
from .dust_type import (SphericalDust, IsotropicDust, HenyeyGreensteinDust,  # noqa: F401
                        HOCHUNKDust, TTsreDust, henyey_greenstein,
                        CoatsphSingle, CoatsphMultiple, MieXDust, BHDust)
