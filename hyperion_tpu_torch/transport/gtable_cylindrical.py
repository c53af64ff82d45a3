"""Cylindrical-polar grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_cylindrical.py``; ref
src/grid/grid_geometry_cylindrical_3d.f90:592-821).

Wall crossings are cylinder-shell quadratics, z planes and meridional
half-planes evaluated for the whole lane batch, with the spherical
module's robustness scheme: engine-unit lengths (divided by the grid's
largest extent), an on-wall exclusion and a direction nudge of
``t_eps * (w + |z|) + eps_floor``, scaled to the local position (float32
rounding shrinks toward the origin, and an auto grid resolves a disk's
rim with cells 1e-4 of the grid), with an absolute floor of 1% of the
smallest wall spacing for packets at the origin. Curved walls are not
snapped onto: the cell index is authoritative.

Flat cell = (i_phi * n_z + i_z) * n_w + i_w. A packet escapes through the
outer cylinder or either z face, or into a non-zero inner hole."""

import math
from dataclasses import dataclass

import numpy as np
import torch

from .gtable import ESCAPED
from .sampling import searchsorted_right


@dataclass
class CylindricalGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3

    ww: torch.Tensor          # (n1+1,) cylindrical-radius walls (engine units)
    ww2: torch.Tensor         # ww^2
    zw: torch.Tensor          # (n2+1,) z walls
    sin_pw: torch.Tensor      # (n3+1,) sin(phi walls)
    cos_pw: torch.Tensor      # (n3+1,)
    phi_w: torch.Tensor       # (n3+1,) wall angles in [0, 2 pi]
    volumes: torch.Tensor     # (n_cells,), = volumes_cgs / length_scale^3
    t_eps: float              # on-wall exclusion, relative to w + |z|
    eps_floor: float          # its absolute floor (engine units)
    n1: int
    n2: int
    n3: int
    length_scale: float

    @property
    def n_cells(self):
        return self.n1 * self.n2 * self.n3

    def decode(self, cell):
        i1 = cell % self.n1
        i2 = (cell // self.n1) % self.n2
        i3 = cell // (self.n1 * self.n2)
        return i1, i2, i3

    def encode(self, i1, i2, i3):
        return (i3 * self.n2 + i2) * self.n1 + i1

    def _big(self, x):
        return torch.finfo(x.dtype).max / 8

    def _eps(self, w0, z):
        """The on-wall exclusion and the nudge of :meth:`find_cell`."""
        return self.t_eps * (w0 + z.abs()) + self.eps_floor

    def find_cell(self, x, y, z, kx, ky, kz):
        """Locate packets by searches in w^2, z and phi at the position
        nudged by ``_eps`` along the direction (the on-wall disambiguation,
        ref adjust_wall); points on the axis belong to the first shell."""
        eps = self._eps(torch.sqrt(x * x + y * y), z)
        xn = x + eps * kx
        yn = y + eps * ky
        zn = z + eps * kz
        w2 = xn * xn + yn * yn
        i1 = (searchsorted_right(self.ww2, w2) - 1).clamp_min(0)
        i2 = searchsorted_right(self.zw, zn) - 1
        if self.n3 == 1:
            i3 = torch.zeros_like(i1)
        else:
            phi = torch.atan2(yn, xn)
            phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
            i3 = (searchsorted_right(self.phi_w, phi) - 1).clamp(
                0, self.n3 - 1)
        inside = (i1 < self.n1) & (i2 >= 0) & (i2 < self.n2) & \
            (w2 >= self.ww2[0])
        return torch.where(inside, self.encode(i1, i2, i3),
                           torch.full_like(i1, ESCAPED))

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """Distance to the closest bounding wall along each ray: the least
        of six candidates (inner and outer cylinder, lower and upper z
        plane, two phi half-planes), each beyond the on-wall exclusion.

        Returns (t, next_cell, which, t): the neighbour is found by the
        direction-aware :meth:`find_cell` at the landing point, so a ray
        that grazes a cylinder or rides a phi half-plane lands on the side
        it really goes to. A ray with no wall ahead gets t = 0 and ESCAPED.
        The last two values stand in for the cartesian crossing axis and
        wall coordinate; :meth:`snap` ignores them."""
        i1, i2, i3 = self.decode(cell)
        big = self._big(x)
        eps = self._eps(torch.sqrt(x * x + y * y), z)
        a = kx * kx + ky * ky
        b = x * kx + y * ky
        pp = x * x + y * y
        has_a = a > 1e-300
        safe_a = torch.where(has_a, a, 1.0)

        def cylinder_crossing(ww2):
            disc = b * b - a * (pp - ww2)
            sq = torch.sqrt(disc.clamp_min(0.0))
            t1 = (-b - sq) / safe_a
            t2 = (-b + sq) / safe_a
            t1 = torch.where(t1 > eps, t1, big)
            t2 = torch.where(t2 > eps, t2, big)
            return torch.where((disc >= 0.0) & has_a, torch.minimum(t1, t2),
                               big)

        ww2_in = self.ww2[i1]
        # an inner wall at w = 0 is the axis, never crossed
        t_w_in = torch.where(ww2_in > 0.0, cylinder_crossing(ww2_in), big)
        t_w_out = cylinder_crossing(self.ww2[i1 + 1])

        def z_crossing(iw):
            t = torch.where(kz.abs() > 1e-300, (self.zw[iw] - z) / kz, big)
            return torch.where(t > eps, t, big)

        def phi_crossing(iw):
            sw = self.sin_pw[iw]
            cw = self.cos_pw[iw]
            # plane normal (-sin, cos, 0); t = -(n.p) / (n.k)
            nv = -sw * kx + cw * ky
            t = torch.where(nv.abs() > 1e-300, -(-sw * x + cw * y) / nv, big)
            # on the half-plane of the wall's own angle
            on_half = ((x + t * kx) * cw + (y + t * ky) * sw) >= 0.0
            return torch.where((t > eps) & on_half, t, big)

        cands = [t_w_in, t_w_out, z_crossing(i2), z_crossing(i2 + 1)]
        if self.n3 > 1:
            cands += [phi_crossing(i3), phi_crossing(i3 + 1)]
        t, which = torch.stack(cands).min(dim=0)
        next_cell = self.find_cell(x + t * kx, y + t * ky, z + t * kz,
                                   kx, ky, kz)
        bad = t >= big
        t = torch.where(bad, 0.0, t)
        next_cell = torch.where(bad, ESCAPED, next_cell)
        return t, next_cell, which, t

    def closest_wall_distance(self, cell, x, y, z):
        """Perpendicular distance to the nearest wall of the cell (the MRW
        trigger): exact for the cylinders and the z planes, w |sin(phi -
        phi_w)| for the phi half-planes."""
        i1, i2, i3 = self.decode(cell)
        w = torch.sqrt(x * x + y * y)
        d = torch.minimum((w - self.ww[i1]).clamp_min(0.0),
                          (self.ww[i1 + 1] - w).clamp_min(0.0))
        d = torch.minimum(d, torch.minimum(z - self.zw[i2],
                                           self.zw[i2 + 1] - z))
        if self.n3 > 1:
            phi = torch.remainder(torch.atan2(y, x), 2.0 * math.pi)
            d_p1 = w * torch.sin(phi - self.phi_w[i3]).abs()
            d_p2 = w * torch.sin(self.phi_w[i3 + 1] - phi).abs()
            d = torch.minimum(d, torch.minimum(d_p1, d_p2))
        return d.clamp_min(0.0)

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Is the position inside the cell's bounds within a ``tol``
        fraction of the cell's extent in w, z and phi? The geometry
        self-check oracle (ref in_correct_cell); phi is not checked on the
        axis, where it is degenerate.

        The margins in w and z are at least twice the on-wall nudge
        ``_eps``, the finest distance the geometry resolves (the nudge, and
        the float32 rounding of w and of the nudged point, a few ulps more),
        as in the spherical module: an auto grid's disk rim and midplane
        cells can be thinner (config 3's 27 rim shells span 7.6e-11 of the
        grid, about one float32 nudge; in float32 the exclusion at w ~ 0.01
        of the grid exceeds the finest z cells), and the JAX function,
        which has no such floor, kills packets there in float32."""
        i1, i2, i3 = self.decode(cell)
        w = torch.sqrt(x * x + y * y)
        eps = 2.0 * self._eps(w, z)
        w_lo = self.ww[i1]
        w_hi = self.ww[i1 + 1]
        m_w = torch.maximum(tol * (w_hi - w_lo), eps)
        ok = (w >= w_lo - m_w) & (w <= w_hi + m_w)
        z_lo = self.zw[i2]
        z_hi = self.zw[i2 + 1]
        m_z = torch.maximum(tol * (z_hi - z_lo), eps)
        ok = ok & (z >= z_lo - m_z) & (z <= z_hi + m_z)
        if self.n3 > 1:
            two_pi = 2.0 * math.pi
            phi = torch.remainder(torch.atan2(y, x), two_pi)
            p_lo = self.phi_w[i3]
            width = self.phi_w[i3 + 1] - p_lo
            m_p = tol * width
            dphi = torch.remainder(phi - p_lo, two_pi)
            on_axis = w <= tol * self.ww[1]
            ok = ok & (on_axis | (dphi <= width + m_p) |
                       (dphi >= two_pi - m_p))
        return ok

    def snap(self, x, y, z, ax, wall_coord, crossed):
        """No snapping onto curved walls: the on-wall exclusion and the
        authoritative cell index keep packets consistent."""
        return x, y, z


def build_cylindrical_geometry(grid, device, dtype):
    """Build the geometry tables of a CylindricalPolarGrid in engine
    units."""
    ww = np.asarray(grid.w_wall, float)
    zw = np.asarray(grid.z_wall, float)
    pw = np.asarray(grid.p_wall, float)
    L = float(max(ww.max(), np.abs(zw).max()))
    spacings = np.concatenate([np.diff(ww), np.diff(zw)]) / L

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    # the tables in the engine's type, and t_eps and eps_floor rounded to
    # it, as the JAX package keeps them
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return CylindricalGeometry(
        ww=f(ww / L), ww2=f((ww / L) ** 2), zw=f(zw / L),
        sin_pw=f(np.sin(pw)), cos_pw=f(np.cos(pw)), phi_w=f(pw),
        volumes=f(grid.volumes.reshape(-1) / L ** 3),
        # float32 needs a larger exclusion than float64
        t_eps=float(np_dtype(3e-6 if dtype == torch.float32 else 1e-12)),
        eps_floor=float(np_dtype(0.01 * float(spacings[spacings > 0].min()))),
        n1=len(ww) - 1, n2=len(zw) - 1, n3=len(pw) - 1, length_scale=L)
