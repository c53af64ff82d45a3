"""Importers of the port: SPH particles into an octree, Orion/BoxLib
plotfiles into an AMR grid (copies of ``hyperion_tpu/importers``)."""

from .orion import OrionStar, parse_orion  # noqa: F401
from .sph import construct_octree  # noqa: F401
