"""Export rtout image cubes and physical grids to FITS files (a copy of
``hyperion_tpu/scripts/tofits.py``, the port's own: it imports nothing of
the JAX package).

Equivalent of the reference's ``scripts/hyperion2fits`` (which shells out to
astropy.io.fits); this build ships its own dependency-free FITS writer
(util/minifits.py) since astropy is not a required dependency.

Usage:
    hyperion_tpu_torch2fits [--images] [--physics] file.rtout [more.rtout ...]
"""

import sys

import numpy as np


def _export_images(filename, f, writeto):
    import os
    base = os.path.splitext(filename)[0]
    count = 0
    if 'Peeled' in f:
        for ig, name in enumerate(sorted(f['Peeled'])):
            group = f['Peeled'][name]
            if 'images' in group:
                image = np.array(group['images'])
                out = '%s_%05i_images.fits' % (base, ig + 1)
                writeto(out, image, overwrite=True)
                print('wrote %s %s' % (out, image.shape))
                count += 1
            if 'seds' in group:
                sed = np.array(group['seds'])
                out = '%s_%05i_seds.fits' % (base, ig + 1)
                writeto(out, sed, overwrite=True)
                print('wrote %s %s' % (out, sed.shape))
                count += 1
    if 'Binned' in f and 'images' in f['Binned']:
        image = np.array(f['Binned']['images'])
        out = '%s_binned_images.fits' % base
        writeto(out, image, overwrite=True)
        print('wrote %s %s' % (out, image.shape))
        count += 1
    return count


def _export_physics(filename, f, writeto):
    import os
    base = os.path.splitext(filename)[0]
    count = 0
    iterations = sorted(k for k in f if k.startswith('iteration_'))
    if not iterations:
        return 0
    g = f[iterations[-1]]
    for name in g:
        data = np.array(g[name])
        out = '%s_%s.fits' % (base, name)
        writeto(out, data, overwrite=True)
        print('wrote %s %s' % (out, data.shape))
        count += 1
    return count


def main(argv=None):
    import h5py
    args = list(sys.argv[1:] if argv is None else argv)
    images = '--images' in args
    physics = '--physics' in args
    args = [a for a in args if not a.startswith('--')]
    if not images and not physics:
        print("Need to specify at least one of --images or --physics")
        return 1
    if not args:
        print("Need at least one rtout file")
        return 1

    try:
        from astropy.io.fits import writeto
    except ImportError:
        from ..util.minifits import writeto

    for filename in args:
        try:
            f = h5py.File(filename, 'r')
        except OSError:
            print("Reading %s failed" % filename)
            continue
        with f:
            if images:
                _export_images(filename, f, writeto)
            if physics:
                _export_physics(filename, f, writeto)
    return 0


if __name__ == '__main__':
    sys.exit(main())
