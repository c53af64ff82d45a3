from .flared_disk import FlaredDisk  # noqa: F401
from .alpha_disk import AlphaDisk  # noqa: F401
from .ulrich_envelope import UlrichEnvelope  # noqa: F401
from .power_law_envelope import PowerLawEnvelope  # noqa: F401
from .bipolar_cavity import BipolarCavity  # noqa: F401
from .ambient_medium import AmbientMedium  # noqa: F401
