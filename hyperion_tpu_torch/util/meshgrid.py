"""N-D meshgrid with reference-compatible axis ordering.

``meshgrid_nd(x1, x2, x3)`` returns arrays of shape (len(x3), len(x2),
len(x1)) — i.e. the first argument varies along the *last* axis, matching the
reference's on-disk quantity layout (ref: hyperion/util/meshgrid.py).
"""

import numpy as np


def meshgrid_nd(*args):
    return tuple(reversed(np.meshgrid(*reversed(args), indexing='ij')))
