"""Model assembly + native engine execution.

Parity target: hyperion/model/model.py:37-1080 (grid setters, density grids
with merge-if-possible, source factories, image groups, minimum temperature/
energy, ``write()`` producing the .rtin schema). The key architectural
difference from the reference: ``run()`` does not shell out to a Fortran
binary — it builds device tables and executes the port's PyTorch transport
engine in-process (``model/run.py``), then writes a reference-layout
``.rtout`` file and returns a ``ModelOutput``.

A copy of ``hyperion_tpu/model/model.py``; only ``run()`` differs.
"""

import os
import datetime

import numpy as np

from .. import __version__
from ..util.functions import FreezableClass, bool2str
from ..conf import RunConf, OutputConf, PeeledImageConf, BinnedImageConf
from ..dust import SphericalDust
from ..grid import (CartesianGrid, CylindricalPolarGrid, SphericalPolarGrid,
                    GridView)
from ..grid.base import single_grid_dims
from ..sources import (PointSource, PointSourceCollection, SphericalSource,
                       ExternalSphericalSource, ExternalBoxSource, MapSource,
                       PlaneParallelSource, read_source)


class Configuration(FreezableClass):

    def __init__(self):
        self.output = OutputConf()
        self._freeze()


class Model(FreezableClass, RunConf):

    def __init__(self, name=None):
        self.conf = Configuration()
        self.name = name
        self.reset_dust()
        self.reset_sources()
        self.reset_images()
        self.grid = None
        self.filename = None
        self._minimum_temperature = None
        self._minimum_specific_energy = None
        self._frequencies = None
        self._initialize_run_conf()
        self._freeze()

    def reset_dust(self):
        self.dust = None

    def reset_sources(self):
        self.sources = []

    def reset_images(self):
        self.binned_output = None
        self.peeled_output = []

    # -- monochromatic mode ---------------------------------------------------

    def set_monochromatic(self, monochromatic, wavelengths=None,
                          frequencies=None):
        """Enable monochromatic imaging at fixed wavelengths (microns) or
        frequencies (Hz)."""
        self._monochromatic = monochromatic
        if monochromatic:
            if wavelengths is not None and frequencies is not None:
                raise Exception("Cannot specify both wavelengths and frequencies")
            elif wavelengths is not None:
                from ..util.constants import c
                # keep the USER's wavelength order (the reference writes
                # frequencies as c/wav without sorting, so the output SED
                # frequency axis matches the requested wavelength list)
                frequencies = c / (np.asarray(wavelengths, float) * 1.e-4)
            elif frequencies is None:
                raise Exception("Need to specify wavelengths or frequencies")
            self._frequencies = np.asarray(frequencies, float)
            for images in self.peeled_output:
                images._set_monochromatic(True, frequencies=self._frequencies)
            if self.binned_output is not None:
                raise Exception("Binned images cannot be used in monochromatic mode")
        else:
            if wavelengths is not None or frequencies is not None:
                raise Exception("Cannot specify wavelengths or frequencies if "
                                "monochromatic=False")
            self._frequencies = None

    def _write_monochromatic(self, group, compression=True):
        group.attrs['monochromatic'] = bool2str(self._monochromatic)
        if self._monochromatic:
            group.create_dataset('frequencies',
                                 data=np.array(list(zip(self._frequencies)),
                                               dtype=[('nu', float)]),
                                 compression='gzip' if compression else None)

    def _read_monochromatic(self, group):
        from ..util.functions import str2bool
        self._monochromatic = str2bool(group.attrs['monochromatic'])
        if self._monochromatic:
            self._frequencies = np.array(group['frequencies']['nu'])

    # -- grid setters ---------------------------------------------------------

    def set_grid(self, grid):
        from ..grid import AMRGrid
        if isinstance(grid, AMRGrid):
            # copy geometry only — densities are added via AMRGridView
            # objects afterwards (ref model.py:889-891)
            self.grid = AMRGrid(grid)
        elif isinstance(grid, GridView):
            self.grid = grid._grid.__class__(grid)
            self.grid.quantities = {}
        else:
            self.grid = grid

    def set_cartesian_grid(self, x_wall, y_wall, z_wall):
        self.set_grid(CartesianGrid(x_wall, y_wall, z_wall))

    def set_cylindrical_polar_grid(self, w_wall, z_wall, p_wall):
        self.set_grid(CylindricalPolarGrid(w_wall, z_wall, p_wall))

    def set_spherical_polar_grid(self, r_wall, t_wall, p_wall):
        self.set_grid(SphericalPolarGrid(r_wall, t_wall, p_wall))

    def set_octree_grid(self, x, y, z, dx, dy, dz, refined):
        from ..grid import OctreeGrid
        self.set_grid(OctreeGrid(x, y, z, dx, dy, dz, refined))

    def set_amr_grid(self, description):
        from ..grid import AMRGrid
        self.set_grid(AMRGrid(description))

    def set_voronoi_grid(self, x, y, z, **kwargs):
        from ..grid import VoronoiGrid
        self.set_grid(VoronoiGrid(x, y, z, **kwargs))

    # -- density --------------------------------------------------------------

    def add_density_grid(self, density, dust, specific_energy=None,
                         merge_if_possible=False):
        """Add one dust population's density (+ optional initial specific
        energy). Merges with an existing identical-dust population when
        ``merge_if_possible`` (ref model.py:772-862)."""
        if self.grid is None:
            raise Exception("A coordinate system/grid has to be defined before "
                            "adding a density grid")

        from ..grid import AMRGrid, AMRGridView
        if isinstance(self.grid, AMRGrid) and not isinstance(self.grid,
                                                             AMRGridView):
            # AMR densities arrive as AMRGridView objects (per-fab arrays)
            if not isinstance(density, AMRGridView):
                raise ValueError("For AMR grids, density should be an "
                                 "AMRGridView instance")
            if 'density' not in self.grid:
                self.dust = []
            self.grid['density'].append(density)
            self.dust.append(dust)
            if specific_energy is not None:
                if not isinstance(specific_energy, AMRGridView):
                    raise ValueError("For AMR grids, specific_energy should "
                                     "be an AMRGridView instance")
                self.grid['specific_energy'].append(specific_energy)
            return

        if isinstance(density, GridView):
            density = density.array
        self.grid._check_array_dimensions(density)
        if specific_energy is not None:
            if isinstance(specific_energy, GridView):
                specific_energy = specific_energy.array
            self.grid._check_array_dimensions(specific_energy)

        if 'density' not in self.grid:
            self.grid['density'] = []
            self.dust = []

        if merge_if_possible and specific_energy is None:
            if isinstance(dust, str):
                dust_obj = SphericalDust(dust)
            else:
                dust_obj = dust
            for i, d in enumerate(self.dust):
                d_obj = SphericalDust(d) if isinstance(d, str) else d
                if d_obj.hash() == dust_obj.hash():
                    self.grid['density'].quantities['density'][i] += density
                    return

        self.grid['density'].append(density)
        self.dust.append(dust)
        if specific_energy is not None:
            if 'specific_energy' not in self.grid:
                self.grid['specific_energy'] = []
                # pad earlier populations with zeros
                for _ in range(len(self.dust) - 1):
                    self.grid['specific_energy'].append(np.zeros(self.grid.shape))
            self.grid['specific_energy'].append(specific_energy)

    # -- sources --------------------------------------------------------------

    def add_source(self, source):
        self.sources.append(source)

    def add_point_source(self, *args, **kwargs):
        source = PointSource(*args, **kwargs)
        self.add_source(source)
        return source

    def add_point_source_collection(self, *args, **kwargs):
        source = PointSourceCollection(*args, **kwargs)
        self.add_source(source)
        return source

    def add_spherical_source(self, *args, **kwargs):
        source = SphericalSource(*args, **kwargs)
        self.add_source(source)
        return source

    def add_external_spherical_source(self, *args, **kwargs):
        source = ExternalSphericalSource(*args, **kwargs)
        self.add_source(source)
        return source

    def add_external_box_source(self, *args, **kwargs):
        source = ExternalBoxSource(*args, **kwargs)
        self.add_source(source)
        return source

    def add_map_source(self, *args, **kwargs):
        source = MapSource(*args, **kwargs)
        self.add_source(source)
        return source

    def add_plane_parallel_source(self, *args, **kwargs):
        source = PlaneParallelSource(*args, **kwargs)
        self.add_source(source)
        return source

    # -- images ---------------------------------------------------------------

    def add_peeled_images(self, **kwargs):
        peel = PeeledImageConf(**kwargs)
        self.peeled_output.append(peel)
        if self._monochromatic:
            peel._set_monochromatic(True, frequencies=self._frequencies)
        return peel

    def add_binned_images(self, **kwargs):
        if self.binned_output is not None:
            raise Exception("Only one set of binned images can be set at this time")
        if self._monochromatic:
            raise Exception("Binned images cannot be used in monochromatic mode")
        self.binned_output = BinnedImageConf(**kwargs)
        return self.binned_output

    # -- minimum temperature / energy ----------------------------------------

    @staticmethod
    def _validate_floor(value, name):
        """Scalar-or-list positivity validation (ref model.py:979-1023:
        'temperature should be positive' / 'should be a numerical value')."""
        for v in np.atleast_1d(value):
            # np.isscalar is False for 0-d array scalars; test numeric-ness
            # with isreal/ndim so np.float64(10.) and np.asarray(10.) validate
            if not (np.ndim(v) == 0 and np.isreal(v)) or isinstance(v, str):
                raise ValueError("%s should be a numerical value" % name)
            if not v > 0:
                raise ValueError("%s should be positive" % name)

    def set_minimum_temperature(self, temperature):
        if self._minimum_specific_energy is not None:
            raise Exception("minimum specific energy has already been set")
        self._validate_floor(temperature, 'temperature')
        self._minimum_temperature = temperature

    def set_minimum_specific_energy(self, specific_energy):
        if self._minimum_temperature is not None:
            raise Exception("minimum temperature has already been set")
        self._validate_floor(specific_energy, 'specific_energy')
        self._minimum_specific_energy = specific_energy

    def _resolved_minimum_specific_energy(self, dusts):
        if self._minimum_temperature is not None:
            mt = self._minimum_temperature
            if np.ndim(mt) == 0:
                mt = [mt] * len(dusts)
            if len(mt) != len(dusts):
                raise Exception("Number of minimum_temperature values "
                                "should match number of dust types")
            return [float(d.temperature2specific_energy(t))
                    for d, t in zip(dusts, mt)]
        if self._minimum_specific_energy is not None:
            me = self._minimum_specific_energy
            if np.ndim(me) == 0:
                me = [me] * len(dusts)
            if len(me) != len(dusts):
                raise Exception("Number of minimum_specific_energy values "
                                "should match number of dust types")
            return [float(e) for e in me]
        return None

    def _dust_objects(self):
        return [SphericalDust(d) if isinstance(d, str) else d
                for d in (self.dust or [])]

    # -- write ----------------------------------------------------------------

    def write(self, filename=None, compression=True, copy=True,
              absolute_paths=False, wall_dtype=float, physics_dtype=float,
              overwrite=True):
        """Write the .rtin model input file (ref model.py:513-732)."""
        import h5py

        if filename is None:
            if self.name is not None:
                filename = self.name + '.rtin'
            else:
                raise ValueError("filename= has not been specified and model "
                                 "has no name")
        if overwrite and os.path.exists(filename):
            os.remove(filename)
        if self.grid is None:
            raise Exception("No coordinate grid has been set up")

        root = h5py.File(filename, 'w')
        root.attrs['python_version'] = np.bytes_(__version__)

        g_sources = root.create_group('Sources')
        g_output = root.create_group('Output')
        g_peeled = g_output.create_group('Peeled')
        g_binned = g_output.create_group('Binned')

        for i, source in enumerate(self.sources):
            if isinstance(source, MapSource):
                source.write(g_sources, 'source_%05i' % (i + 1), self.grid,
                             compression=compression,
                             map_dtype=physics_dtype)
            else:
                source.write(g_sources, 'source_%05i' % (i + 1))

        for i, peel in enumerate(self.peeled_output):
            if self._frequencies is not None and not peel._monochromatic:
                raise Exception("Peeled images need to be set to monochromatic mode")
            peel.write(g_peeled.create_group('group_%05i' % (i + 1)))

        if self.binned_output is not None:
            if self.forced_first_interaction:
                raise Exception("can't use binned images with forced first "
                                "interaction - use "
                                "set_forced_first_interaction(False) to disable")
            self.binned_output.write(g_binned.create_group('group_00001'))

        self._write_monochromatic(root, compression=compression)
        self.write_run_conf(root)
        self.conf.output.write(g_output)

        from ..grid import GridOnDisk
        if isinstance(self.grid, GridOnDisk):
            # embed by reference (external link) or deep-copy the group
            # (ref model.py:607-610 link_or_copy)
            if copy:
                with h5py.File(self.grid.filename, 'r') as fsrc:
                    fsrc.copy(self.grid.path, root, name='Grid')
            else:
                root['Grid'] = self.grid.link
            g_grid = None
        else:
            g_grid = root.create_group('Grid')
            self.grid._check_array_dimensions()
            self.grid.write(g_grid, copy=copy, absolute_paths=absolute_paths,
                            compression=compression,
                            physics_dtype=physics_dtype)

        if 'density' in self.grid:
            if self.dust is None:
                raise Exception("No dust properties specified")
            g_dust = root.create_group('Dust')
            if self.grid['density'].n_pop != len(self.dust):
                raise Exception("Number of density grids should match number "
                                "of dust types")
            present = {}
            for i, dust in enumerate(self.dust):
                short_name = 'dust_%03i' % (i + 1)
                if isinstance(dust, str):
                    dust = SphericalDust(dust)
                if dust.hash() in present:
                    # group-RELATIVE soft link: an absolute /Dust/... path
                    # would dangle when the .rtin is embedded under /Input
                    # of the output file (ref main.f90:135-151 copy_input)
                    g_dust[short_name] = h5py.SoftLink(present[dust.hash()])
                else:
                    dust.write(g_dust.create_group(short_name))
                    present[dust.hash()] = short_name

            min_se = self._resolved_minimum_specific_energy(self._dust_objects())
            if min_se is not None:
                if g_grid is None:
                    raise ValueError("Cannot set minimum specific energy or "
                                     "temperature when using a grid from "
                                     "disk")
                g_grid['Quantities'].attrs['minimum_specific_energy'] = \
                    [float(x) for x in min_se]
        else:
            root.create_group('Dust')

        root.close()
        self.filename = filename

    @classmethod
    def read(cls, filename, only_initial=True):
        """Read a model from an .rtin (or embedded /Input) file."""
        import h5py

        self = cls()
        f = h5py.File(filename, 'r')
        if 'Input' in f:
            g = f['Input']
        else:
            g = f

        # Grid — assigned directly (not via set_grid): the file carries the
        # density/specific_energy quantities that set_grid would discard
        # (this is the engine-side reader, ref setup_rt.f90:160-228)
        grid_type = g['Grid/Geometry'].attrs['grid_type'].decode('ascii')
        from ..grid import OctreeGrid, AMRGrid, VoronoiGrid
        grid_classes = {'car': CartesianGrid, 'cyl_pol': CylindricalPolarGrid,
                        'sph_pol': SphericalPolarGrid, 'oct': OctreeGrid,
                        'amr': AMRGrid, 'vor': VoronoiGrid}
        if grid_type not in grid_classes:
            raise NotImplementedError("Grid type %s not yet supported"
                                      % grid_type)
        grid = grid_classes[grid_type]()
        grid.read(g['Grid'])
        self.grid = grid

        # Dust
        self.dust = []
        if 'Dust' in g:
            for name in sorted(g['Dust']):
                self.dust.append(SphericalDust(g['Dust'][name]))
        if not self.dust:
            self.dust = None

        # Sources
        for name in sorted(g['Sources']):
            self.sources.append(read_source(g['Sources'][name]))

        # Images
        if 'Output' in g:
            self.conf.output = OutputConf.read(g['Output'])
            if 'Peeled' in g['Output']:
                for name in sorted(g['Output/Peeled']):
                    peel = PeeledImageConf()
                    peel.read(g['Output/Peeled'][name])
                    self.peeled_output.append(peel)
            if 'Binned' in g['Output'] and len(g['Output/Binned']) > 0:
                self.binned_output = BinnedImageConf()
                self.binned_output.read(g['Output/Binned/group_00001'])

        self._read_monochromatic(g)
        self.read_run_conf(g)

        if 'minimum_specific_energy' in g['Grid/Quantities'].attrs:
            self.set_minimum_specific_energy(
                [float(x) for x in
                 g['Grid/Quantities'].attrs['minimum_specific_energy']])

        f.close()
        return self

    # -- reuse of previous runs (ref model.py:174-361) -------------------------

    @staticmethod
    def _previous_run_group(f):
        """Root group of a model description inside ``f``: the file itself
        for .rtin files, /Input for .rtout files."""
        if 'Grid' in f:
            return f
        if 'Input' in f:
            # resolve through the external-link workaround: access via the
            # link's own file handle so h5py follows it transparently
            g = f['Input']
            return g.file[g.name] if g.file != f.file else g
        raise Exception("No model found in file")

    def use_geometry(self, filename):
        """Adopt the grid geometry (walls only, no quantities) from a
        previous input or output file (ref model.py:174-225)."""
        import h5py
        from ..grid import OctreeGrid, AMRGrid, VoronoiGrid

        classes = {'car': CartesianGrid, 'cyl_pol': CylindricalPolarGrid,
                   'sph_pol': SphericalPolarGrid, 'oct': OctreeGrid,
                   'amr': AMRGrid, 'vor': VoronoiGrid}
        with h5py.File(filename, 'r') as f:
            g_grid = self._previous_run_group(f)['Grid']
            grid_type = g_grid['Geometry'].attrs['grid_type'].decode('utf-8')
            if grid_type not in classes:
                raise NotImplementedError("Cannot read geometry type %s"
                                          % grid_type)
            grid = classes[grid_type]()
            grid.read(g_grid, quantities=[])
        self.set_grid(grid)

    def use_quantities(self, filename, quantities=None,
                       use_minimum_specific_energy=True, use_dust=True,
                       copy=True, only_initial=False):
        """Load physical quantities from a previous run (ref model.py:226-360).

        By default reads density + specific_energy from the LAST Lucy
        iteration of an output file (so a new run continues from the
        converged state); ``only_initial`` restricts to the embedded input.
        ``copy=False`` stores h5py.ExternalLinks instead of arrays.
        """
        import h5py
        from .helpers import find_last_iteration

        if self.grid is None:
            raise Exception("Call use_geometry() or set a grid before "
                            "use_quantities()")
        if quantities is None:
            quantities = ['density', 'specific_energy']

        f = h5py.File(filename, 'r')
        try:
            is_output = 'Input' in f or 'Grid' not in f
            base = self._previous_run_group(f)
            q_base = base['Grid/Quantities']

            last = None
            if is_output and not only_initial:
                n_last = find_last_iteration(f)
                if n_last > 0:
                    last = f['iteration_%05i' % n_last]

            paths = {}
            for q in quantities:
                if last is not None and q in last:
                    paths[q] = last
                elif q in q_base:
                    paths[q] = q_base
            for q, grp in paths.items():
                if copy:
                    self.grid.read_quantities(grp, quantities=[q])
                else:
                    self.grid[q] = h5py.ExternalLink(
                        os.path.abspath(filename), grp[q].name)

            if use_minimum_specific_energy and \
                    'minimum_specific_energy' in q_base.attrs:
                self.set_minimum_specific_energy(
                    [float(x) for x in
                     q_base.attrs['minimum_specific_energy']])

            if use_dust and 'Dust' in base:
                self.dust = [SphericalDust(base['Dust'][name])
                             for name in sorted(base['Dust'])]
        finally:
            f.close()

    def use_grid_from_file(self, filename, path='/', dust=[]):
        """Reference a grid inside an existing HDF5 file without reading it
        into memory (ref model.py:897-914): ``write()`` embeds it as an
        external link (``copy=False``) or deep-copies the group. ``dust``
        lists one dust file/object per density population in the grid."""
        from ..grid import GridOnDisk
        self.grid = GridOnDisk(filename, path=path)
        self.dust = dust

    def use_sources(self, filename):
        """Adopt the source list from a previous input/output file
        (ref model.py:361-395)."""
        import h5py
        with h5py.File(filename, 'r') as f:
            base = self._previous_run_group(f)
            for name in sorted(base['Sources']):
                self.add_source(read_source(base['Sources'][name]))

    def use_run_conf(self, filename):
        """Adopt the run configuration (photon counts, flags, convergence)
        from a previous input/output file (ref model.py:395-410)."""
        import h5py
        with h5py.File(filename, 'r') as f:
            self.read_run_conf(self._previous_run_group(f))

    def use_output_config(self, filename):
        """Adopt the grid-output configuration from a previous file."""
        import h5py
        with h5py.File(filename, 'r') as f:
            base = self._previous_run_group(f)
            self.conf.output = OutputConf.read(base['Output'])

    def use_image_config(self, filename):
        """Adopt peeled/binned image groups from a previous file."""
        import h5py
        with h5py.File(filename, 'r') as f:
            base = self._previous_run_group(f)
            if 'Peeled' in base['Output']:
                for name in sorted(base['Output/Peeled']):
                    peel = PeeledImageConf()
                    peel.read(base['Output/Peeled'][name])
                    self.peeled_output.append(peel)
            if 'Binned' in base['Output'] and len(base['Output/Binned']) > 0:
                self.binned_output = BinnedImageConf()
                self.binned_output.read(base['Output/Binned/group_00001'])

    # -- run ------------------------------------------------------------------

    def run(self, filename=None, logfile=None, mpi=False, n_processes=1,
            overwrite=True, device=None, batch_size=None, dtype=None):
        """Run the model with the port's transport engine and return a
        ModelOutput. ``device`` is 'cuda' (the default, which needs a card)
        or 'cpu'. ``n_processes > 1`` runs it on that many ranks, as
        ``mpirun -n`` does (they share the cards when there are fewer);
        ``mpi=True`` alone runs a rank per card, one on the CPU
        (:mod:`..parallel`)."""
        from .run import run_model
        from .model_output import ModelOutput

        if self.filename is None:
            raise Exception("Model has not been written yet - call write() first")
        if filename is None:
            if self.filename.endswith('.rtin'):
                filename = self.filename.replace('.rtin', '.rtout')
            else:
                filename = self.filename + '.rtout'
        if not overwrite and os.path.exists(filename):
            raise Exception("Output file exists and overwrite=False")

        parallel = (n_processes if n_processes and n_processes > 1
                    else bool(mpi))
        run_model(self, filename, device=device, batch_size=batch_size,
                  dtype=dtype, parallel=parallel)
        return ModelOutput(filename)
