"""Read and post-process .rtout files (ref: hyperion/model/model_output.py).

Implements the same data products: ``get_sed``/``get_image`` with component
selection, unit conversion and distance scaling; ``get_quantities`` returning
the physical grids with derived dust temperature.
"""

import numpy as np

from ..util.constants import c, pi
from ..util.functions import FreezableClass, asstr, str2bool

STOKESD = {'I': 0, 'Q': 1, 'U': 2, 'V': 3}


class ModelOutput(FreezableClass):
    """Access the output of a model run."""

    def __init__(self, name):
        import h5py
        import os
        if not os.path.exists(name):
            raise IOError("File not found: %s" % name)
        self.filename = name
        self.file = h5py.File(name, 'r')
        self._freeze()

    def close(self):
        self.file.close()

    # -- helpers --------------------------------------------------------------

    def _get_origin_slice(self, dset, component, source_id=None, dust_id=None,
                          n_scat=None):
        """Map a component name to origin-axis indices.

        Returns an int (single slice) or ('sum', [indices]) to sum slices.
        Slice layouts per track_origin mode follow the reference
        (image_type.f90:228-241,443-461; model_output.py:126-210):
        basic = [src_emit, dust_emit, src_scat, dust_scat];
        detailed = [per-source emit][per-dust emit][per-source scat]
        [per-dust scat]; scatterings = [0..K scat, >K][same, reprocessed].
        """
        track_origin = asstr(dset.attrs['track_origin'])
        if track_origin == 'no' and component != 'total':
            raise Exception("cannot extract component=%s - file only contains "
                            "total flux" % component)
        if track_origin != 'detailed' and (source_id is not None or
                                           dust_id is not None):
            raise Exception("cannot specify source_id/dust_id since "
                            "track_origin was not set to 'detailed'")

        if track_origin == 'basic':
            mapping = {'source_emit': 0, 'dust_emit': 1,
                       'source_scat': 2, 'dust_scat': 3}
            if component in mapping:
                return mapping[component]
            if component == 'source':
                return ('sum', [0, 2])
            if component == 'dust':
                return ('sum', [1, 3])
            raise ValueError("component should be one of total/source_emit/"
                             "dust_emit/source_scat/dust_scat/source/dust")

        if track_origin == 'detailed':
            ns = int(dset.attrs['n_sources'])
            nd = int(dset.attrs['n_dust'])
            starts = {'source_emit': (0, ns, source_id),
                      'dust_emit': (ns, nd, dust_id),
                      'source_scat': (ns + nd, ns, source_id),
                      'dust_scat': (2 * ns + nd, nd, dust_id)}
            if component not in starts:
                raise ValueError(
                    "component should be one of total/source_emit/dust_emit/"
                    "source_scat/dust_scat since track_origin='detailed'")
            start, count, which = starts[component]
            if which is None or which == 'all':
                return ('sum', list(range(start, start + count)))
            if which < 0 or which >= count:
                raise ValueError("%s_id should be between 0 and %i"
                                 % (component.split('_')[0], count - 1))
            return start + which

        if track_origin == 'scatterings':
            track_n_scat = int(dset.attrs.get('track_n_scat', 0))
            half = track_n_scat + 2
            if component == 'source':
                base = 0
            elif component == 'dust':
                base = half
            else:
                raise ValueError("component should be one of total/source/"
                                 "dust since track_origin='scatterings'")
            if n_scat is None:
                return ('sum', list(range(base, base + half)))
            if n_scat < 0 or n_scat > track_n_scat:
                raise ValueError("n_scat should be between 0 and %i"
                                 % track_n_scat)
            return base + n_scat

        raise ValueError("track_origin should be one of "
                         "basic/detailed/scatterings")

    def _select_group(self, technique, group):
        if technique == 'peeled':
            n_groups = len(self.file['Peeled'])
            if group < 0:
                group = n_groups + group
            if group < 0 or group >= n_groups:
                raise ValueError('File only contains %i image/SED group(s)'
                                 % n_groups)
            return self.file['Peeled/group_%05i' % (group + 1)]
        return self.file['Binned']

    def _wavelengths(self, g, dset):
        if 'numin' in dset.attrs:
            numin = dset.attrs['numin']
            numax = dset.attrs['numax']
            wavmin, wavmax = c / numax * 1.e4, c / numin * 1.e4
            wav = np.logspace(np.log10(wavmax), np.log10(wavmin),
                              dset.shape[-1] * 2 + 1)[1::2]
            nu = c / wav * 1.e4
        else:
            nu = np.array(g['frequencies']['nu'])
            wav = c / nu * 1.e4
        return nu, wav

    def _flux_scale(self, nu, units, distance, inside_observer):
        if units is None:
            units = 'ergs/s' if (distance is None and not inside_observer) \
                else 'ergs/cm^2/s'
        if distance is not None or inside_observer:
            if units == 'ergs/cm^2/s':
                scale = np.ones_like(nu)
            elif units == 'ergs/cm^2/s/Hz':
                scale = 1.0 / nu
            elif units == 'Jy':
                scale = 1.e23 / nu
            elif units == 'mJy':
                scale = 1.e26 / nu
            else:
                raise ValueError("Unknown units: %s" % units)
            if distance:
                scale = scale / (4.0 * pi * distance ** 2)
        else:
            if units != 'ergs/s':
                raise ValueError("Since distance= is not specified, units "
                                 "should be set to ergs/s")
            scale = np.ones_like(nu)
        return scale, units

    def _postprocess_cube(self, flux, unc, component, aperture_axis,
                          inclination, aperture, stokes, io, uncertainties):
        """Shared slicing for seds and images. flux has shape
        (n_stokes, n_orig, n_view, ..., n_nu)."""
        if aperture_axis and aperture != 'all':
            if not isinstance(aperture, int):
                raise TypeError('aperture should be an integer')
            flux = flux[:, :, :, aperture]
            if uncertainties:
                unc = unc[:, :, :, aperture]
        if inclination != 'all':
            if not isinstance(inclination, int):
                raise TypeError('inclination should be an integer')
            flux = flux[:, :, inclination]
            if uncertainties:
                unc = unc[:, :, inclination]

        if component == 'total':
            flux = np.sum(flux, axis=1)
            if uncertainties:
                unc = np.sqrt(np.sum(unc ** 2, axis=1))
        elif isinstance(io, int):
            flux = flux[:, io]
            if uncertainties:
                unc = unc[:, io]
        elif isinstance(io, tuple):
            idx = io[1]
            flux = flux[:, idx].sum(axis=1)
            if uncertainties:
                unc = np.sqrt((unc[:, idx] ** 2).sum(axis=1))
        else:
            raise Exception("Unknown component: %s" % component)

        if flux.shape[0] == 1 and stokes != 'I':
            raise ValueError("Only the Stokes I value was stored")
        if stokes in STOKESD:
            flux = flux[STOKESD[stokes]]
            if uncertainties:
                unc = unc[STOKESD[stokes]]
        elif stokes == 'linpol':
            with np.errstate(invalid='ignore'):
                flux = np.sqrt((flux[1] ** 2 + flux[2] ** 2) / flux[0] ** 2)
            flux[np.isnan(flux)] = 0.0
        elif stokes == 'circpol':
            with np.errstate(invalid='ignore'):
                flux = np.abs(flux[3] / flux[0])
            flux[np.isnan(flux)] = 0.0
        else:
            raise ValueError("Unknown Stokes parameter: %s" % stokes)
        return flux, unc

    # -- SEDs -----------------------------------------------------------------

    def get_sed(self, stokes='I', group=0, technique='peeled', distance=None,
                component='total', inclination='all', aperture='all',
                uncertainties=False, units=None, source_id=None, dust_id=None,
                n_scat=None):
        """Retrieve an SED (ref model_output.py:212-540). Returns an SED."""
        from .sed import SED as SEDClass

        if not isinstance(stokes, str):
            raise ValueError("stokes argument should be a string")
        if distance is not None and stokes in ('linpol', 'circpol'):
            raise Exception("Cannot scale polarization degree by distance")

        g = self._select_group(technique, group)
        if 'seds' not in g:
            raise Exception("Group %i does not contain any SEDs" % group)
        if uncertainties and 'seds_unc' not in g:
            raise Exception("Uncertainties requested but not present in file")

        dset = g['seds']
        io = None
        if 'track_origin' in dset.attrs and component != 'total':
            io = self._get_origin_slice(dset, component, source_id, dust_id,
                                        n_scat)

        nu, wav = self._wavelengths(g, dset)
        flux = dset[()].astype(np.float64)
        unc = g['seds_unc'][()].astype(np.float64) if uncertainties else None

        inside_observer = str2bool(g.attrs.get('inside_observer', b'no'))
        if inside_observer and distance is not None:
            raise ValueError("Cannot specify distance for inside observers")

        scale, units = self._flux_scale(nu, units, distance, inside_observer)
        if stokes in STOKESD:
            flux = flux * scale
            if uncertainties:
                unc = unc * scale

        flux, unc = self._postprocess_cube(flux, unc, component, True,
                                           inclination, aperture, stokes, io,
                                           uncertainties)

        sed = SEDClass(nu=nu, val=flux, unc=unc if uncertainties else None,
                       units=units)
        sed.ap_min = dset.attrs.get('apmin')
        sed.ap_max = dset.attrs.get('apmax')
        sed.d_min = g.attrs.get('d_min')
        sed.d_max = g.attrs.get('d_max')
        sed.distance = distance
        sed.inside_observer = inside_observer
        return sed

    # -- images ---------------------------------------------------------------

    def get_image(self, stokes='I', group=0, technique='peeled', distance=None,
                  component='total', inclination='all', uncertainties=False,
                  units=None, source_id=None, dust_id=None, n_scat=None):
        """Retrieve an image (ref model_output.py:539-770). Returns an Image."""
        from .image import Image as ImageClass

        if not isinstance(stokes, str):
            raise ValueError("stokes argument should be a string")

        g = self._select_group(technique, group)
        if 'images' not in g:
            raise Exception("Group %i does not contain any images" % group)
        if uncertainties and 'images_unc' not in g:
            raise Exception("Uncertainties requested but not present in file")

        dset = g['images']
        io = None
        if 'track_origin' in dset.attrs and component != 'total':
            io = self._get_origin_slice(dset, component, source_id, dust_id,
                                        n_scat)

        nu, wav = self._wavelengths(g, dset)
        flux = dset[()].astype(np.float64)
        unc = g['images_unc'][()].astype(np.float64) if uncertainties else None

        inside_observer = str2bool(g.attrs.get('inside_observer', b'no'))
        if inside_observer and distance is not None:
            raise ValueError("Cannot specify distance for inside observers")

        if units == 'MJy/sr':
            # surface brightness: divide by the pixel solid angle
            # (ref model_output.py:794-797; 1e17 = 1e23 Jy / 1e6 MJy)
            if distance is None and not inside_observer:
                raise ValueError("Need to specify distance= for MJy/sr")
            nx = flux.shape[-2]
            ny = flux.shape[-3]
            dx = (float(dset.attrs['xmax']) - float(dset.attrs['xmin'])) / nx
            dy = (float(dset.attrs['ymax']) - float(dset.attrs['ymin'])) / ny
            if inside_observer:
                # limits are angles in degrees on the sky
                pix_area_sr = np.radians(abs(dx)) * np.radians(abs(dy))
                scale = 1.e17 / nu / pix_area_sr
            else:
                pix_area_sr = abs(dx) * abs(dy) / distance ** 2
                scale = 1.e17 / nu / pix_area_sr / (4.0 * pi * distance ** 2)
        else:
            scale, units = self._flux_scale(nu, units, distance,
                                            inside_observer)
        if stokes in STOKESD:
            flux = flux * scale
            if uncertainties:
                unc = unc * scale

        flux, unc = self._postprocess_cube(flux, unc, component, False,
                                           inclination, 'all', stokes, io,
                                           uncertainties)

        img = ImageClass(nu=nu, val=flux, unc=unc if uncertainties else None,
                         units=units)
        img.x_min = dset.attrs.get('xmin')
        img.x_max = dset.attrs.get('xmax')
        img.y_min = dset.attrs.get('ymin')
        img.y_max = dset.attrs.get('ymax')
        img.d_min = g.attrs.get('d_min')
        img.d_max = g.attrs.get('d_max')
        img.distance = distance
        img.inside_observer = inside_observer
        return img

    # -- physical grids -------------------------------------------------------

    def _last_iteration(self):
        iterations = [int(name.split('_')[1]) for name in self.file
                      if name.startswith('iteration')]
        if not iterations:
            raise Exception("No iterations found in file")
        return max(iterations)

    def get_quantities(self, iteration=-1):
        """Return the grid with physical quantities from an iteration,
        including the derived 'temperature' quantity
        (ref model_output.py:975-1065)."""
        from ..grid import (CartesianGrid, CylindricalPolarGrid,
                            SphericalPolarGrid, OctreeGrid, VoronoiGrid,
                            AMRGrid)
        from ..dust import SphericalDust

        n_iter = self._last_iteration()
        if iteration < 0:
            iteration = n_iter + iteration + 1
        if iteration < 1 or iteration > n_iter:
            raise ValueError("iteration out of range")
        g_iter = self.file['iteration_%05i' % iteration]

        g_input = self.file['Input'] if 'Input' in self.file else self.file
        grid_type = asstr(g_input['Grid/Geometry'].attrs['grid_type'])
        grid_classes = {'car': CartesianGrid, 'cyl_pol': CylindricalPolarGrid,
                        'sph_pol': SphericalPolarGrid, 'oct': OctreeGrid,
                        'vor': VoronoiGrid, 'amr': AMRGrid}
        grid = grid_classes[grid_type]()
        grid.read_geometry(g_input['Grid/Geometry'])

        if grid_type == 'amr':
            # iteration groups hold level_*/grid_* datasets
            for ilevel, level in enumerate(grid.levels):
                g_level = g_iter['level_%05i' % (ilevel + 1)]
                for igrid, fab in enumerate(level.grids):
                    g_fab = g_level['grid_%05i' % (igrid + 1)]
                    for quantity in g_fab:
                        arr = np.array(g_fab[quantity])
                        if arr.ndim == 4:
                            fab.quantities[quantity] = [
                                arr[i] for i in range(arr.shape[0])]
                        else:
                            fab.quantities[quantity] = arr
        else:
            for quantity in g_iter:
                arr = np.array(g_iter[quantity])
                if arr.ndim > len(grid.shape):
                    grid.quantities[quantity] = [arr[i]
                                                 for i in range(arr.shape[0])]
                else:
                    grid.quantities[quantity] = arr

        # Derived temperature from specific energy via the dust model
        if 'Dust' in g_input:
            dusts = [SphericalDust(g_input['Dust'][name])
                     for name in sorted(g_input['Dust'])]
            if grid_type == 'amr':
                for level in grid.levels:
                    for fab in level.grids:
                        if 'specific_energy' not in fab.quantities:
                            continue
                        fab.quantities['temperature'] = [
                            d.specific_energy2temperature(
                                fab.quantities['specific_energy'][i])
                            for i, d in enumerate(dusts)]
            elif 'specific_energy' in grid.quantities:
                grid.quantities['temperature'] = [
                    d.specific_energy2temperature(
                        grid.quantities['specific_energy'][i])
                    for i, d in enumerate(dusts)]

        return grid

    def get_available_components(self, iteration=-1):
        n_iter = self._last_iteration()
        if iteration < 0:
            iteration = n_iter + iteration + 1
        components = list(self.file['iteration_%05i' % iteration])
        # temperature is derived from specific_energy through the dust model
        # (ref model_output.py get_available_components)
        if 'specific_energy' in components:
            components.append('temperature')
        return components
