from .base import StructuredGrid, GridView  # noqa: F401
from .cartesian_grid import CartesianGrid  # noqa: F401
from .cylindrical_polar_grid import CylindricalPolarGrid  # noqa: F401
from .spherical_polar_grid import SphericalPolarGrid  # noqa: F401
from .octree_grid import OctreeGrid  # noqa: F401
from .amr_grid import AMRGrid, AMRGridView  # noqa: F401
from .voronoi_grid import VoronoiGrid  # noqa: F401
from .grid_on_disk import GridOnDisk  # noqa: F401
