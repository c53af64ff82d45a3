from .source import (Source, PointSource, PointSourceCollection,  # noqa: F401
                     SphericalSource, SpotSource, ExternalSphericalSource,
                     ExternalBoxSource, MapSource, PlaneParallelSource,
                     read_source)
