"""Run/output/image configuration with the reference's .rtin attribute schema.

Parity target: hyperion/conf/conf_files.py (OutputConf :12-44, RunConf
:48-823, ImageConf :827-1240, BinnedImageConf :1242-1275, PeeledImageConf
:1277-1420). Every engine knob keeps its HDF5 attribute name so model files
are interchangeable with the reference.
"""

import numpy as np

from ..util.functions import FreezableClass, bool2str, str2bool, asstr, \
    is_numpy_array, monotonically_increasing
from ..util.validator import validate_scalar
from ..filter import Filter


class OutputConf(FreezableClass):
    """Which gridded quantities to output ('all', 'last', or 'none')."""

    def __init__(self):
        self.output_density = 'none'
        self.output_density_diff = 'last'
        self.output_specific_energy = 'last'
        self.output_specific_energy_spectrum = 'none'
        self.output_n_photons = 'none'
        self._freeze()

    def _check(self):
        for attr in ('output_density', 'output_density_diff',
                     'output_specific_energy',
                     'output_specific_energy_spectrum', 'output_n_photons'):
            if getattr(self, attr) not in ('all', 'last', 'none'):
                raise Exception("%s should be one of all/last/none" % attr)

    def write(self, group):
        self._check()
        group.attrs['output_density'] = np.bytes_(self.output_density)
        group.attrs['output_density_diff'] = np.bytes_(self.output_density_diff)
        group.attrs['output_specific_energy'] = np.bytes_(self.output_specific_energy)
        group.attrs['output_specific_energy_spectrum'] = \
            np.bytes_(self.output_specific_energy_spectrum)
        group.attrs['output_n_photons'] = np.bytes_(self.output_n_photons)

    @classmethod
    def read(cls, group):
        self = cls()
        self.output_density = asstr(group.attrs['output_density'])
        self.output_density_diff = asstr(group.attrs['output_density_diff'])
        self.output_specific_energy = asstr(group.attrs['output_specific_energy'])
        if 'output_specific_energy_spectrum' in group.attrs:
            self.output_specific_energy_spectrum = \
                asstr(group.attrs['output_specific_energy_spectrum'])
        self.output_n_photons = asstr(group.attrs['output_n_photons'])
        return self


class RunConf(object):
    """Mixin holding every transport-engine run parameter."""

    def _initialize_run_conf(self):
        self.set_propagation_check_frequency(0.001)
        self.set_seed(-124902)
        self.n_iterations = 5
        self.n_photons = {}
        self.raytracing = False
        self.set_max_interactions(1000000)
        self.set_max_reabsorptions(1000000)
        self.set_pda(False)
        self.set_mrw(False)
        self.specific_energy_spectrum_bins = None
        self.set_convergence(False)
        self.set_kill_on_absorb(False)
        self.set_kill_on_scatter(False)
        self.set_forced_first_interaction(True)
        self.set_output_bytes(8)
        self.set_sample_sources_evenly(False)
        self.set_enforce_energy_range(True)
        self.set_copy_input(True)
        self.set_specific_energy_type('initial')
        self._monochromatic = False

    # -- individual knobs -----------------------------------------------------

    def set_propagation_check_frequency(self, frequency):
        """Probability per integration step of re-verifying the packet's cell
        (ref conf_files.py:75)."""
        if not np.isscalar(frequency) or frequency < 0 or frequency > 1:
            raise ValueError("frequency should be a scalar in [0:1]")
        self._frequency = frequency

    def set_seed(self, seed):
        if not np.isscalar(seed) or seed != int(seed):
            raise ValueError("seed should be an integer")
        self._seed = int(seed)

    def set_n_initial_iterations(self, n_iter):
        """Number of Lucy temperature iterations before imaging."""
        self.n_iterations = int(n_iter)

    def set_n_photons(self, initial=None, imaging=None,
                      imaging_sources=None, imaging_dust=None,
                      raytracing_sources=None, raytracing_dust=None,
                      stats=10000):
        """Photon counts per phase (ref conf_files.py:142-296)."""
        if imaging is not None and (imaging_sources is not None or
                                    imaging_dust is not None):
            raise Exception("imaging and imaging_sources/imaging_dust "
                            "cannot both be specified")
        if self._monochromatic:
            if imaging is not None:
                raise Exception("imaging photon count should not be set in "
                                "monochromatic mode")
        else:
            if imaging_sources is not None or imaging_dust is not None:
                raise Exception("imaging_sources and imaging_dust should not "
                                "be set in non-monochromatic mode")
        self.n_photons = {}
        if initial is not None:
            self.n_photons['initial'] = int(initial)
        if imaging is not None:
            self.n_photons['last'] = int(imaging)
        if imaging_sources is not None:
            self.n_photons['last_sources'] = int(imaging_sources)
        if imaging_dust is not None:
            self.n_photons['last_dust'] = int(imaging_dust)
        if raytracing_sources is not None:
            self.n_photons['raytracing_sources'] = int(raytracing_sources)
        if raytracing_dust is not None:
            self.n_photons['raytracing_dust'] = int(raytracing_dust)
        self.n_photons['stats'] = int(stats)

    def set_raytracing(self, raytracing):
        self.raytracing = bool(raytracing)

    def set_max_interactions(self, inter_max, warn=True):
        self.n_inter_max = int(inter_max)
        self.n_inter_max_warn = bool(warn)

    def set_max_reabsorptions(self, reabs_max, warn=True):
        self.n_reabs_max = int(reabs_max)
        self.n_reabs_max_warn = bool(warn)

    def set_pda(self, pda):
        """Partial diffusion approximation for poorly sampled cells."""
        self.pda = bool(pda)

    def set_mrw(self, mrw, gamma=1.0, inter_max=1000, warn=True):
        """Modified random walk (Min+ 2009) diffusion acceleration."""
        self.mrw = bool(mrw)
        self.mrw_gamma = gamma
        self.n_inter_mrw_max = int(inter_max)
        self.n_inter_mrw_max_warn = bool(warn)

    def set_specific_energy_spectrum_bins(self, edges):
        """Frequency bin edges for the nu-resolved absorbed-energy spectrum."""
        if edges is not None:
            edges = np.asarray(edges, float)
            if edges.ndim != 1 or len(edges) < 2:
                raise ValueError("edges should be a 1-D array of at least 2 values")
            if not monotonically_increasing(edges):
                raise ValueError("edges should be monotonically increasing")
        self.specific_energy_spectrum_bins = edges

    def set_convergence(self, convergence, percentile=100., absolute=0.,
                        relative=0.):
        self.check_convergence = bool(convergence)
        self.convergence_percentile = percentile
        self.convergence_absolute = absolute
        self.convergence_relative = relative

    def set_kill_on_absorb(self, kill_on_absorb):
        self.kill_on_absorb = bool(kill_on_absorb)

    def set_kill_on_scatter(self, kill_on_scatter):
        self.kill_on_scatter = bool(kill_on_scatter)

    def set_forced_first_interaction(self, forced_first_interaction,
                                     algorithm='wr99', baes16_xi=0.5):
        if algorithm not in ('wr99', 'baes16'):
            raise ValueError("algorithm should be one of wr99/baes16")
        if baes16_xi < 0 or baes16_xi > 1:
            raise ValueError("baes16_xi should be in the range [0:1]")
        self.forced_first_interaction = bool(forced_first_interaction)
        self.forced_first_interaction_algorithm = algorithm
        self.forced_first_interaction_baes16_xi = baes16_xi

    def set_enforce_energy_range(self, enforce):
        self.enforce_energy_range = bool(enforce)

    def set_copy_input(self, copy):
        self.copy_input = bool(copy)

    def set_output_bytes(self, io_bytes):
        if io_bytes not in (4, 8):
            raise ValueError("io_bytes should be 4 or 8")
        self.physics_io_bytes = io_bytes

    def set_sample_sources_evenly(self, sample_sources_evenly):
        self.sample_sources_evenly = bool(sample_sources_evenly)

    def set_specific_energy_type(self, specific_energy_type):
        if specific_energy_type not in ('initial', 'additional'):
            raise ValueError("specific_energy_type should be one of "
                             "initial/additional")
        self.specific_energy_type = specific_energy_type

    # -- I/O ------------------------------------------------------------------

    def write_run_conf(self, group):
        group.attrs['propagation_check_frequency'] = self._frequency
        group.attrs['seed'] = self._seed
        group.attrs['n_initial_iter'] = self.n_iterations
        if 'initial' in self.n_photons:
            group.attrs['n_initial_photons'] = self.n_photons['initial']
        if 'last' in self.n_photons:
            group.attrs['n_last_photons'] = self.n_photons['last']
        if 'last_sources' in self.n_photons:
            group.attrs['n_last_photons_sources'] = self.n_photons['last_sources']
        if 'last_dust' in self.n_photons:
            group.attrs['n_last_photons_dust'] = self.n_photons['last_dust']
        if 'raytracing_sources' in self.n_photons:
            group.attrs['n_ray_photons_sources'] = self.n_photons['raytracing_sources']
        if 'raytracing_dust' in self.n_photons:
            group.attrs['n_ray_photons_dust'] = self.n_photons['raytracing_dust']
        group.attrs['n_stats'] = self.n_photons.get('stats', 10000)
        group.attrs['raytracing'] = bool2str(self.raytracing)
        group.attrs['n_inter_max'] = self.n_inter_max
        group.attrs['n_inter_max_warn'] = bool2str(self.n_inter_max_warn)
        group.attrs['n_reabs_max'] = self.n_reabs_max
        group.attrs['n_reabs_max_warn'] = bool2str(self.n_reabs_max_warn)
        group.attrs['pda'] = bool2str(self.pda)
        group.attrs['mrw'] = bool2str(self.mrw)
        if self.mrw:
            group.attrs['mrw_gamma'] = self.mrw_gamma
            group.attrs['n_inter_mrw_max'] = self.n_inter_mrw_max
            group.attrs['n_inter_mrw_max_warn'] = bool2str(self.n_inter_mrw_max_warn)
        if self.specific_energy_spectrum_bins is not None:
            group.attrs['compute_specific_energy_spectrum'] = bool2str(True)
            # reference rtin schema: structured table with an 'nu' column
            # (ref conf_files.py _write_specific_energy_spectrum_bins)
            edges = np.asarray(self.specific_energy_spectrum_bins, float)
            group.create_dataset(
                'specific_energy_spectrum_bin_edges',
                data=np.array(list(zip(edges)), dtype=[('nu', float)]))
        else:
            group.attrs['compute_specific_energy_spectrum'] = bool2str(False)
        group.attrs['check_convergence'] = bool2str(self.check_convergence)
        if self.check_convergence:
            group.attrs['convergence_percentile'] = self.convergence_percentile
            group.attrs['convergence_absolute'] = self.convergence_absolute
            group.attrs['convergence_relative'] = self.convergence_relative
        group.attrs['kill_on_absorb'] = bool2str(self.kill_on_absorb)
        group.attrs['kill_on_scatter'] = bool2str(self.kill_on_scatter)
        group.attrs['forced_first_interaction'] = bool2str(self.forced_first_interaction)
        group.attrs['forced_first_interaction_algorithm'] = \
            np.bytes_(self.forced_first_interaction_algorithm)
        group.attrs['forced_first_interaction_baes16_xi'] = \
            self.forced_first_interaction_baes16_xi
        group.attrs['physics_io_bytes'] = self.physics_io_bytes
        group.attrs['sample_sources_evenly'] = bool2str(self.sample_sources_evenly)
        group.attrs['enforce_energy_range'] = bool2str(self.enforce_energy_range)
        group.attrs['copy_input'] = bool2str(self.copy_input)
        group.attrs['specific_energy_type'] = np.bytes_(self.specific_energy_type)

    def read_run_conf(self, group):
        self.set_propagation_check_frequency(
            group.attrs.get('propagation_check_frequency', 0.001))
        self.set_seed(group.attrs['seed'])
        self.n_iterations = int(group.attrs['n_initial_iter'])
        self.n_photons = {}
        for key, attr in (('initial', 'n_initial_photons'),
                          ('last', 'n_last_photons'),
                          ('last_sources', 'n_last_photons_sources'),
                          ('last_dust', 'n_last_photons_dust'),
                          ('raytracing_sources', 'n_ray_photons_sources'),
                          ('raytracing_dust', 'n_ray_photons_dust'),
                          ('stats', 'n_stats')):
            if attr in group.attrs:
                self.n_photons[key] = int(group.attrs[attr])
        self.raytracing = str2bool(group.attrs['raytracing'])
        self.set_max_interactions(
            group.attrs['n_inter_max'],
            warn=str2bool(group.attrs.get('n_inter_max_warn', b'yes')))
        self.set_max_reabsorptions(
            group.attrs['n_reabs_max'],
            warn=str2bool(group.attrs.get('n_reabs_max_warn', b'yes')))
        self.pda = str2bool(group.attrs['pda'])
        self.mrw = str2bool(group.attrs['mrw'])
        if self.mrw:
            self.mrw_gamma = float(group.attrs['mrw_gamma'])
            self.n_inter_mrw_max = int(group.attrs['n_inter_mrw_max'])
            self.n_inter_mrw_max_warn = \
                str2bool(group.attrs.get('n_inter_mrw_max_warn', b'yes'))
        if 'specific_energy_spectrum_bin_edges' in group:
            self.specific_energy_spectrum_bins = \
                np.array(group['specific_energy_spectrum_bin_edges']['nu'])
        elif 'specific_energy_spectrum_bins' in group:
            # older snapshots of this project wrote a plain dataset
            self.specific_energy_spectrum_bins = \
                np.array(group['specific_energy_spectrum_bins'])
        self.check_convergence = str2bool(group.attrs['check_convergence'])
        if self.check_convergence:
            self.convergence_percentile = float(group.attrs['convergence_percentile'])
            self.convergence_absolute = float(group.attrs['convergence_absolute'])
            self.convergence_relative = float(group.attrs['convergence_relative'])
        self.kill_on_absorb = str2bool(group.attrs['kill_on_absorb'])
        if 'kill_on_scatter' in group.attrs:
            self.kill_on_scatter = str2bool(group.attrs['kill_on_scatter'])
        if 'forced_first_scattering' in group.attrs:  # pre-0.9.9 files
            self.forced_first_interaction = \
                str2bool(group.attrs['forced_first_scattering'])
        else:
            self.forced_first_interaction = \
                str2bool(group.attrs['forced_first_interaction'])
            self.forced_first_interaction_algorithm = \
                asstr(group.attrs['forced_first_interaction_algorithm'])
            self.forced_first_interaction_baes16_xi = \
                float(group.attrs['forced_first_interaction_baes16_xi'])
        if 'physics_io_bytes' in group.attrs:
            self.physics_io_bytes = int(group.attrs['physics_io_bytes'])
        self.sample_sources_evenly = str2bool(group.attrs['sample_sources_evenly'])
        self.enforce_energy_range = str2bool(group.attrs['enforce_energy_range'])
        if 'copy_input' in group.attrs:
            self.copy_input = str2bool(group.attrs['copy_input'])
        if 'specific_energy_type' in group.attrs:
            self.specific_energy_type = asstr(group.attrs['specific_energy_type'])


class ImageConf(FreezableClass):
    """Common image/SED configuration (size, limits, wavelengths, apertures,
    origin tracking, uncertainties, Stokes)."""

    def __init__(self, sed=True, image=True):
        self.sed = sed
        self.image = image
        if self.sed:
            self.set_aperture_radii(1, np.inf, np.inf)
        if self.image:
            self.n_x = self.n_y = None
            self.xmin = self.xmax = self.ymin = self.ymax = None
        self.n_wav = None
        self.wav_min = None
        self.wav_max = None
        self.iwav_min = None
        self.iwav_max = None
        self.set_output_bytes(8)
        self.set_track_origin('no')
        self.set_uncertainties(False)
        self.set_stokes(False)
        self._set_monochromatic(False)
        self._filters = []
        self._freeze()

    def add_filter(self, **kwargs):
        filt = Filter(**kwargs)
        self._filters.append(filt)
        return filt

    def set_output_bytes(self, io_bytes):
        if io_bytes not in (4, 8):
            raise ValueError("io_bytes should be 4 or 8")
        self.io_bytes = io_bytes

    def set_image_size(self, n_x, n_y):
        self.n_x = int(n_x)
        self.n_y = int(n_y)

    def set_image_limits(self, xmin, xmax, ymin, ymax):
        for v, name in ((xmin, 'xmin'), (xmax, 'xmax'), (ymin, 'ymin'),
                        (ymax, 'ymax')):
            validate_scalar(name, v)
        self.xmin, self.xmax, self.ymin, self.ymax = xmin, xmax, ymin, ymax

    def set_aperture_range(self, n_ap, ap_min, ap_max):
        return self.set_aperture_radii(n_ap, ap_min, ap_max)

    def set_aperture_radii(self, n_ap, ap_min, ap_max):
        self.n_ap = int(n_ap)
        self.ap_min = ap_min
        self.ap_max = ap_max

    def set_wavelength_range(self, n_wav, wav_min, wav_max):
        """Wavelengths in microns, binned log-uniformly."""
        self.n_wav = int(n_wav)
        self.wav_min = wav_min
        self.wav_max = wav_max

    def set_wavelength_index_range(self, iwav_min, iwav_max):
        """For monochromatic mode: indices into the frequency list."""
        if not self._monochromatic:
            raise Exception("set_wavelength_index_range cannot be used unless "
                            "monochromatic mode is enabled")
        self.iwav_min = int(iwav_min)
        self.iwav_max = int(iwav_max)

    def set_track_origin(self, track_origin, n_scat=None):
        if track_origin not in ('no', 'basic', 'detailed', 'scatterings'):
            raise Exception("track_origin should be one of "
                            "no/basic/detailed/scatterings")
        if track_origin != 'scatterings' and n_scat is not None:
            raise Exception("n_scat can only be used with track_origin='scatterings'")
        self.track_origin = track_origin
        # the reference defaults a missing n_scat to 0 (conf_files.py
        # set_track_origin: track_n_scat = n_scat or 0)
        self.track_n_scat = n_scat or 0

    def set_uncertainties(self, uncertainties):
        self.uncertainties = bool(uncertainties)

    def set_stokes(self, stokes):
        self.stokes = bool(stokes)

    def _set_monochromatic(self, monochromatic, frequencies=None):
        self._monochromatic = monochromatic
        if monochromatic and frequencies is not None:
            self.iwav_min = 0
            self.iwav_max = len(frequencies) - 1

    def _check(self):
        if self.image:
            if self.n_x is None or self.n_y is None:
                raise Exception("Image size has not been set")
            if self.xmin is None or self.xmax is None or \
               self.ymin is None or self.ymax is None:
                raise Exception("Image limits have not been set")
        if self._monochromatic:
            if self.iwav_min is None or self.iwav_max is None:
                raise Exception("Wavelength index range has not been set "
                                "(monochromatic mode)")
        else:
            if self.n_wav is None and len(self._filters) == 0:
                raise Exception("Wavelength range (or filters) has not been set")

    def write(self, group):
        self._check()
        group.attrs['io_bytes'] = self.io_bytes
        group.attrs['compute_sed'] = bool2str(self.sed)
        group.attrs['compute_image'] = bool2str(self.image)
        if self.image:
            group.attrs['n_x'] = self.n_x
            group.attrs['n_y'] = self.n_y
            group.attrs['x_min'] = self.xmin
            group.attrs['x_max'] = self.xmax
            group.attrs['y_min'] = self.ymin
            group.attrs['y_max'] = self.ymax
        if self.sed:
            group.attrs['n_ap'] = self.n_ap
            group.attrs['ap_min'] = self.ap_min
            group.attrs['ap_max'] = self.ap_max
        group.attrs['monochromatic'] = bool2str(self._monochromatic)
        if self._monochromatic:
            group.attrs['n_wav'] = self.iwav_max - self.iwav_min + 1
            group.attrs['inu_min'] = self.iwav_min + 1
            group.attrs['inu_max'] = self.iwav_max + 1
        elif self.n_wav is not None:
            group.attrs['n_wav'] = self.n_wav
            group.attrs['wav_min'] = self.wav_min
            group.attrs['wav_max'] = self.wav_max
        self._write_filters(group)
        group.attrs['track_origin'] = np.bytes_(self.track_origin)
        if self.track_origin == 'scatterings':
            group.attrs['track_n_scat'] = self.track_n_scat
        group.attrs['uncertainties'] = bool2str(self.uncertainties)
        group.attrs['compute_stokes'] = bool2str(self.stokes)

    def _write_filters(self, group):
        if self._filters:
            if self.n_wav is not None:
                raise ValueError("Cannot specify both filters and wavelength range")
            group.attrs['use_filters'] = bool2str(True)
            group.attrs['n_filt'] = len(self._filters)
            for i, filt in enumerate(self._filters):
                filt.to_hdf5_group(group, 'filter_{0:05d}'.format(i + 1))
        else:
            group.attrs['use_filters'] = bool2str(False)

    def read(self, group):
        self.io_bytes = int(group.attrs['io_bytes'])
        self.sed = str2bool(group.attrs['compute_sed'])
        self.image = str2bool(group.attrs['compute_image'])
        if self.image:
            self.n_x = int(group.attrs['n_x'])
            self.n_y = int(group.attrs['n_y'])
            self.xmin = float(group.attrs['x_min'])
            self.xmax = float(group.attrs['x_max'])
            self.ymin = float(group.attrs['y_min'])
            self.ymax = float(group.attrs['y_max'])
        if self.sed:
            self.n_ap = int(group.attrs['n_ap'])
            self.ap_min = float(group.attrs['ap_min'])
            self.ap_max = float(group.attrs['ap_max'])
        self._monochromatic = str2bool(group.attrs['monochromatic'])
        if self._monochromatic:
            self.iwav_min = int(group.attrs['inu_min']) - 1
            self.iwav_max = int(group.attrs['inu_max']) - 1
        elif 'wav_min' in group.attrs:
            self.n_wav = int(group.attrs['n_wav'])
            self.wav_min = float(group.attrs['wav_min'])
            self.wav_max = float(group.attrs['wav_max'])
        if 'use_filters' in group.attrs and str2bool(group.attrs['use_filters']):
            self._filters = [Filter.from_hdf5_group(group, 'filter_{0:05d}'.format(i + 1))
                             for i in range(int(group.attrs['n_filt']))]
        self.track_origin = asstr(group.attrs['track_origin'])
        if self.track_origin == 'scatterings':
            self.track_n_scat = int(group.attrs['track_n_scat'])
        self.uncertainties = str2bool(group.attrs['uncertainties'])
        if 'compute_stokes' in group.attrs:
            self.stokes = str2bool(group.attrs['compute_stokes'])
        return self


class BinnedImageConf(ImageConf):
    """Images binned by photon exit direction (theta, phi bins)."""

    def __init__(self, n_theta=None, n_phi=None, **kwargs):
        self.n_theta = n_theta
        self.n_phi = n_phi
        ImageConf.__init__(self, **kwargs)

    def set_viewing_bins(self, n_theta, n_phi):
        self.n_theta = int(n_theta)
        self.n_phi = int(n_phi)

    def _check(self):
        ImageConf._check(self)
        if self.n_theta is None or self.n_phi is None:
            raise Exception("Viewing bins have not been set")

    def write(self, group):
        ImageConf.write(self, group)
        group.attrs['n_theta'] = self.n_theta
        group.attrs['n_phi'] = self.n_phi

    def read(self, group):
        ImageConf.read(self, group)
        self.n_theta = int(group.attrs['n_theta'])
        self.n_phi = int(group.attrs['n_phi'])
        return self


class PeeledImageConf(ImageConf):
    """Peeloff images at explicit viewing angles."""

    def __init__(self, **kwargs):
        self.viewing_angles = None
        self.inside_observer = None
        self.peeloff_origin = None
        self.ignore_optical_depth = False
        self.d_min = None
        self.d_max = None
        ImageConf.__init__(self, **kwargs)

    def set_viewing_angles(self, theta, phi):
        """Viewing angles in degrees (two same-length sequences)."""
        if len(theta) != len(phi):
            raise Exception("Length of theta and phi arrays do not match")
        self.viewing_angles = list(zip(np.asarray(theta, float),
                                       np.asarray(phi, float)))

    @property
    def n_view(self):
        if self.inside_observer is not None:
            return len(self.viewing_angles) if self.viewing_angles else 1
        return len(self.viewing_angles) if self.viewing_angles else 0

    def set_inside_observer(self, position):
        self.inside_observer = tuple(np.asarray(position, float))

    def set_ignore_optical_depth(self, ignore_optical_depth):
        self.ignore_optical_depth = bool(ignore_optical_depth)

    def set_peeloff_origin(self, position):
        self.peeloff_origin = tuple(np.asarray(position, float))

    def set_depth(self, d_min, d_max):
        self.d_min = d_min
        self.d_max = d_max

    def _check(self):
        ImageConf._check(self)
        if self.viewing_angles is None and self.inside_observer is None:
            raise Exception("Viewing angles or inside observer have not been set")

    def write(self, group):
        if self.inside_observer is not None:
            if self.peeloff_origin is not None:
                raise Exception("Cannot specify inside observer and peeloff origin")
        self._check()
        ImageConf.write(self, group)
        if self.inside_observer is not None:
            group.attrs['inside_observer'] = bool2str(True)
            group.attrs['observer_x'] = self.inside_observer[0]
            group.attrs['observer_y'] = self.inside_observer[1]
            group.attrs['observer_z'] = self.inside_observer[2]
            # viewing angles define the sky-map centers (default: toward +x)
            angles = self.viewing_angles or [(90.0, 0.0)]
            group.attrs['n_view'] = len(angles)
            group.create_dataset('angles',
                                 data=np.array(angles,
                                               dtype=[('theta', float),
                                                      ('phi', float)]))
        else:
            group.attrs['inside_observer'] = bool2str(False)
            if self.peeloff_origin is None:
                self.peeloff_origin = (0.0, 0.0, 0.0)
            group.attrs['peeloff_x'] = self.peeloff_origin[0]
            group.attrs['peeloff_y'] = self.peeloff_origin[1]
            group.attrs['peeloff_z'] = self.peeloff_origin[2]
            group.attrs['n_view'] = len(self.viewing_angles)
            theta = [a[0] for a in self.viewing_angles]
            phi = [a[1] for a in self.viewing_angles]
            group.create_dataset('angles',
                                 data=np.array(list(zip(theta, phi)),
                                               dtype=[('theta', float),
                                                      ('phi', float)]))
        group.attrs['ignore_optical_depth'] = bool2str(self.ignore_optical_depth)
        if self.d_min is None or self.d_max is None:
            group.attrs['d_min'] = -np.inf
            group.attrs['d_max'] = +np.inf
        else:
            group.attrs['d_min'] = self.d_min
            group.attrs['d_max'] = self.d_max

    def read(self, group):
        ImageConf.read(self, group)
        if str2bool(group.attrs['inside_observer']):
            self.inside_observer = (float(group.attrs['observer_x']),
                                    float(group.attrs['observer_y']),
                                    float(group.attrs['observer_z']))
            if 'angles' in group:
                angles = group['angles']
                self.set_viewing_angles(angles['theta'], angles['phi'])
        else:
            self.peeloff_origin = (float(group.attrs['peeloff_x']),
                                   float(group.attrs['peeloff_y']),
                                   float(group.attrs['peeloff_z']))
            angles = group['angles']
            self.set_viewing_angles(angles['theta'], angles['phi'])
        self.ignore_optical_depth = str2bool(group.attrs['ignore_optical_depth'])
        d_min = float(group.attrs['d_min'])
        d_max = float(group.attrs['d_max'])
        if np.isfinite(d_min) or np.isfinite(d_max):
            self.d_min, self.d_max = d_min, d_max
        return self
