"""Minimal FITS image writer/reader (no astropy dependency); a copy of
``hyperion_tpu/util/minifits.py``, whose bytes it writes.

Implements just enough of the FITS standard (2880-byte header records of
80-character keyword cards, big-endian primary/extension image data) to
export rtout image cubes (see scripts/tofits.py, the equivalent of the
reference's scripts/hyperion2fits which uses astropy.io.fits).
"""

import numpy as np

_BLOCK = 2880

_BITPIX = {
    np.dtype('>u1'): 8, np.dtype('>i2'): 16, np.dtype('>i4'): 32,
    np.dtype('>i8'): 64, np.dtype('>f4'): -32, np.dtype('>f8'): -64,
}


def _card(key, value=None, comment=None):
    """Format one 80-character header card."""
    if value is None:
        s = key.ljust(80)
    else:
        if isinstance(value, bool):
            v = 'T' if value else 'F'
            v = v.rjust(20)
        elif isinstance(value, (int, np.integer)):
            v = str(int(value)).rjust(20)
        elif isinstance(value, (float, np.floating)):
            v = ('%.14E' % float(value)).rjust(20)
        else:
            v = ("'%s'" % str(value).replace("'", "''")).ljust(20)
        s = '%-8s= %s' % (key[:8], v)
        if comment:
            s += ' / ' + comment
        s = s[:80].ljust(80)
    return s.encode('ascii')


def _header_bytes(cards):
    data = b''.join(cards) + _card('END')
    pad = (-len(data)) % _BLOCK
    return data + b' ' * pad


def _data_bytes(arr):
    raw = arr.tobytes()
    pad = (-len(raw)) % _BLOCK
    return raw + b'\0' * pad


def _to_big_endian(data):
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        dt = np.dtype('>f8')
    elif arr.dtype == np.float32:
        dt = np.dtype('>f4')
    elif arr.dtype.kind in 'iu':
        dt = np.dtype('>i8') if arr.dtype.itemsize > 4 else np.dtype('>i4')
    else:
        dt = np.dtype('>f8')
        arr = arr.astype(float)
    return np.ascontiguousarray(arr.astype(dt))


def writeto(filename, data, header=None, overwrite=True):
    """Write a single-HDU FITS image file.

    ``header`` is an optional dict of extra keyword cards (8-char keys)."""
    import os
    if os.path.exists(filename) and not overwrite:
        raise OSError("%s exists" % filename)
    arr = _to_big_endian(data)
    cards = [_card('SIMPLE', True, 'minifits'),
             _card('BITPIX', _BITPIX[arr.dtype]),
             _card('NAXIS', arr.ndim)]
    # FITS axis order is reversed relative to the C row-major shape
    for i, n in enumerate(arr.shape[::-1]):
        cards.append(_card('NAXIS%d' % (i + 1), n))
    for key, val in (header or {}).items():
        cards.append(_card(key, val))
    with open(filename, 'wb') as f:
        f.write(_header_bytes(cards))
        f.write(_data_bytes(arr))


def readfrom(filename):
    """Read a single-HDU FITS image written by :func:`writeto`.

    Returns (data, header_dict). Only the subset of the standard produced by
    ``writeto`` is supported (used by the round-trip tests)."""
    with open(filename, 'rb') as f:
        raw = f.read()
    header = {}
    pos = 0
    while True:
        card = raw[pos:pos + 80].decode('ascii')
        pos += 80
        key = card[:8].strip()
        if key == 'END':
            break
        if card[8:10] == '= ':
            v = card[10:].split('/')[0].strip()
            if v.startswith("'"):
                header[key] = v.strip("'").strip()
            elif v == 'T':
                header[key] = True
            elif v == 'F':
                header[key] = False
            elif '.' in v or 'E' in v:
                header[key] = float(v)
            else:
                header[key] = int(v)
    pos = ((pos + _BLOCK - 1) // _BLOCK) * _BLOCK
    bitpix = header['BITPIX']
    dt = {8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8',
          -32: '>f4', -64: '>f8'}[bitpix]
    shape = tuple(header['NAXIS%d' % (i + 1)]
                  for i in range(header['NAXIS']))[::-1]
    n = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(raw, dtype=np.dtype(dt), count=n,
                         offset=pos).reshape(shape)
    return data, header
