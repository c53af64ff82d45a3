"""Spherical-polar grid geometry of the port (counterpart of
``hyperion_tpu/transport/gtable_spherical.py``).

Wall crossings are sphere, cone, midplane and meridional half-plane
intersections evaluated for the whole lane batch. Robustness comes from
engine-unit lengths (divided by the outer radius), a per-lane minimum
crossing distance ``t_eps * (r + rw[1])`` that excludes the on-wall root,
and a direction nudge of the same size in :meth:`find_cell`, which decides
on which side of a wall a packet lies. Curved walls are not snapped onto:
the cell index is authoritative.

Flat cell = (i_phi * n_t + i_t) * n_r + i_r. Crossing beyond the outer
radial wall, or inward of a non-zero inner wall, escapes the grid (ref
escaped_cell checks only the radius). The JAX module's packed-row twins
(``wall_columns``, ``*_rows``, ``relocate_rows``) are a TPU gather
workaround and have no counterpart here."""

import math
from dataclasses import dataclass

import numpy as np
import torch

from .gtable import ESCAPED
from .sampling import searchsorted_right


@dataclass
class SphericalGeometry:
    # the uniforms a position in one of its cells takes (position_uniforms)
    POSITION_ROWS = 3

    rw: torch.Tensor          # (n1+1,) radial walls (engine units)
    rw2: torch.Tensor         # rw^2
    cos_tw: torch.Tensor      # (n2+1,) cos(theta walls), descending
    cos2_tw: torch.Tensor     # cos^2(theta walls)
    # (n2+1,) 0 a pole (never crossed), 1 a cone, 2 the midplane
    theta_kind: torch.Tensor
    sin_pw: torch.Tensor      # (n3+1,) sin(phi walls)
    cos_pw: torch.Tensor      # (n3+1,)
    phi_w: torch.Tensor       # (n3+1,) wall angles in [0, 2 pi]
    volumes: torch.Tensor     # (n_cells,), = volumes_cgs / length_scale^3
    t_eps: float              # on-wall exclusion, relative to the radius
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

    def find_cell(self, x, y, z, kx, ky, kz):
        """Locate packets by searches in r, cos(theta) and phi, at the
        position nudged by ``t_eps * (r + rw[1])`` along the direction (the
        on-wall disambiguation, ref adjust_wall)."""
        eps = self.t_eps * (torch.sqrt(x * x + y * y + z * z) + self.rw[1])
        xn = x + eps * kx
        yn = y + eps * ky
        zn = z + eps * kz
        r2 = xn * xn + yn * yn + zn * zn
        i1 = searchsorted_right(self.rw2, r2) - 1
        # theta walls ascend, so cos(theta) descends: search on -cos
        cost = (zn / torch.sqrt(r2.clamp_min(1e-300))).clamp(-1.0, 1.0)
        i2 = (searchsorted_right(-self.cos_tw, -cost) - 1).clamp(
            0, self.n2 - 1)
        if self.n3 == 1:
            i3 = torch.zeros_like(i1)
        else:
            phi = torch.atan2(yn, xn)
            phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
            i3 = (searchsorted_right(self.phi_w, phi) - 1).clamp(
                0, self.n3 - 1)
        inside = (i1 >= 0) & (i1 < self.n1)
        return torch.where(inside, self.encode(i1, i2, i3),
                           torch.full_like(i1, ESCAPED))

    def find_wall(self, cell, x, y, z, kx, ky, kz):
        """Distance to the closest bounding wall along each ray: the least
        of six candidates (inner and outer sphere, lower and upper theta
        wall, two phi half-planes), each beyond the on-wall exclusion.

        Returns (t, next_cell, which, t): the neighbour is found by the
        direction-aware :meth:`find_cell` at the landing point, so a ray
        that grazes a curved wall lands on the side it really goes to. A
        ray with no wall ahead (t >= big) gets t = 0 and ESCAPED. The last
        two values stand in for the cartesian crossing axis and wall
        coordinate; :meth:`snap` ignores them."""
        i1, i2, i3 = self.decode(cell)
        big = self._big(x)
        b = x * kx + y * ky + z * kz
        pp = x * x + y * y + z * z
        # scaled to the local radius: float32 noise is relative, and
        # log-spaced cells shrink toward the origin
        eps = self.t_eps * (torch.sqrt(pp) + self.rw[1])

        def sphere_crossing(rw2):
            disc = b * b - (pp - rw2)
            sq = torch.sqrt(disc.clamp_min(0.0))
            t1 = -b - sq
            t2 = -b + sq
            t1 = torch.where(t1 > eps, t1, big)
            t2 = torch.where(t2 > eps, t2, big)
            return torch.where(disc >= 0.0, torch.minimum(t1, t2), big)

        rw2_in = self.rw2[i1]
        # an inner wall at r = 0 is a point, never crossed
        t_r_in = torch.where(rw2_in > 0.0, sphere_crossing(rw2_in), big)
        t_r_out = sphere_crossing(self.rw2[i1 + 1])

        def cone_crossing(iw):
            kind = self.theta_kind[iw]
            cw = self.cos_tw[iw]
            c2 = self.cos2_tw[iw]
            # (c2 - kz^2) t^2 + 2 (c2 b - z kz) t + (c2 pp - z^2) = 0
            a_q = c2 - kz * kz
            b_q = c2 * b - z * kz
            c_q = c2 * pp - z * z
            disc = b_q * b_q - a_q * c_q
            sq = torch.sqrt(disc.clamp_min(0.0))
            lin = a_q.abs() <= 1e-12
            safe_a = torch.where(lin, 1.0, a_q)
            tq1 = (-b_q - sq) / safe_a
            tq2 = (-b_q + sq) / safe_a
            # a ray parallel to the cone surface: the linear root
            t_lin = torch.where(b_q.abs() > 1e-300, -0.5 * c_q / b_q, big)
            tq1 = torch.where(lin, t_lin, tq1)
            tq2 = torch.where(lin, big, tq2)
            # the crossing must be on the cone's own nappe
            ok1 = (disc >= 0.0) & (tq1 > eps) & ((z + tq1 * kz) * cw >= 0.0)
            ok2 = (disc >= 0.0) & (tq2 > eps) & ((z + tq2 * kz) * cw >= 0.0)
            t_cone = torch.minimum(torch.where(ok1, tq1, big),
                                   torch.where(ok2, tq2, big))
            t_mid = torch.where(kz != 0.0, -z / kz, big)
            t_mid = torch.where(t_mid > eps, t_mid, big)
            return torch.where(kind == 2, t_mid,
                               torch.where(kind == 1, t_cone, big))

        def phi_crossing(iw):
            sw = self.sin_pw[iw]
            cw = self.cos_pw[iw]
            # plane normal (-sin, cos, 0); t = -(n.p) / (n.k)
            nv = -sw * kx + cw * ky
            t = torch.where(nv.abs() > 1e-300, -(-sw * x + cw * y) / nv, big)
            # on the half-plane of the wall's own angle
            on_half = ((x + t * kx) * cw + (y + t * ky) * sw) >= 0.0
            return torch.where((t > eps) & on_half, t, big)

        cands = [t_r_in, t_r_out, cone_crossing(i2), cone_crossing(i2 + 1)]
        if self.n3 > 1:
            cands += [phi_crossing(i3), phi_crossing(i3 + 1)]
        ts = torch.stack(cands)
        t, which = ts.min(dim=0)
        next_cell = self.find_cell(x + t * kx, y + t * ky, z + t * kz,
                                   kx, ky, kz)
        bad = t >= big
        t = torch.where(bad, 0.0, t)
        next_cell = torch.where(bad, ESCAPED, next_cell)
        return t, next_cell, which, t

    def closest_wall_distance(self, cell, x, y, z):
        """Perpendicular distance to the nearest wall of the cell (the MRW
        trigger): exact for the spheres; r |sin(theta - theta_w)| for the
        cones (the pole walls are no walls); w |sin(phi - phi_w)| for the
        phi half-planes."""
        i1, i2, i3 = self.decode(cell)
        r = torch.sqrt(x * x + y * y + z * z)
        big = self._big(x)
        d = torch.minimum((r - self.rw[i1]).clamp_min(0.0),
                          (self.rw[i1 + 1] - r).clamp_min(0.0))
        theta = torch.arccos((z / r.clamp_min(1e-300)).clamp(-1.0, 1.0))
        theta_w = torch.arccos(self.cos_tw.clamp(-1.0, 1.0))
        d_lo = torch.where(self.theta_kind[i2] != 0,
                           r * torch.sin(theta - theta_w[i2]).abs(), big)
        d_up = torch.where(self.theta_kind[i2 + 1] != 0,
                           r * torch.sin(theta - theta_w[i2 + 1]).abs(), big)
        d = torch.minimum(d, torch.minimum(d_lo, d_up))
        if self.n3 > 1:
            w = torch.sqrt(x * x + y * y)
            phi = torch.remainder(torch.atan2(y, x), 2.0 * math.pi)
            d_p1 = w * torch.sin(phi - self.phi_w[i3]).abs()
            d_p2 = w * torch.sin(self.phi_w[i3 + 1] - phi).abs()
            d = torch.minimum(d, torch.minimum(d_p1, d_p2))
        return d.clamp_min(0.0)

    def in_cell_tol(self, cell, x, y, z, tol=0.01):
        """Is the position inside the cell's bounds within a ``tol``
        fraction of the cell's extent in r, cos(theta) and phi? The
        geometry self-check oracle (ref in_correct_cell); angles are not
        checked at the origin or on the axis, where they are degenerate.

        The radial margin is at least the on-wall nudge t_eps * (r + rw[1]),
        the finest distance the geometry resolves: an auto grid's innermost
        shells can be thinner (relative widths of 1e-7 at a YSO disk's rim,
        where float32 walls coincide), and the JAX function, which has no
        such floor, kills packets there in float32."""
        i1, i2, i3 = self.decode(cell)
        r = torch.sqrt(x * x + y * y + z * z)
        r_lo = self.rw[i1]
        r_hi = self.rw[i1 + 1]
        m_r = torch.maximum(tol * (r_hi - r_lo),
                            self.t_eps * (r + self.rw[1]))
        ok = (r >= r_lo - m_r) & (r <= r_hi + m_r)
        at_origin = r <= tol * self.rw[1]
        mu = z / r.clamp_min(1e-300)
        mu_hi = self.cos_tw[i2]
        mu_lo = self.cos_tw[i2 + 1]
        m_mu = tol * (mu_hi - mu_lo)
        ok = ok & (at_origin | ((mu >= mu_lo - m_mu) & (mu <= mu_hi + m_mu)))
        if self.n3 > 1:
            two_pi = 2.0 * math.pi
            phi = torch.remainder(torch.atan2(y, x), two_pi)
            p_lo = self.phi_w[i3]
            width = self.phi_w[i3 + 1] - p_lo
            m_p = tol * width
            dphi = torch.remainder(phi - p_lo, two_pi)
            on_axis = torch.sqrt(x * x + y * y) <= tol * self.rw[1]
            ok = ok & (on_axis | (dphi <= width + m_p) |
                       (dphi >= two_pi - m_p))
        return ok

    def snap(self, x, y, z, ax, wall_coord, crossed):
        """No snapping onto curved walls: the on-wall exclusion and the
        authoritative cell index keep packets consistent."""
        return x, y, z


def build_spherical_geometry(grid, device, dtype):
    """Build the geometry tables of a SphericalPolarGrid in engine units."""
    rw = np.asarray(grid.r_wall, float)
    tw = np.asarray(grid.t_wall, float)
    pw = np.asarray(grid.p_wall, float)
    L = float(rw.max())
    cos_tw = np.cos(tw)
    theta_kind = np.ones(len(tw), dtype=np.int64)
    # poles: sin(theta) == 0, a degenerate wall never crossed
    theta_kind[np.abs(np.sin(tw)) < 1e-12] = 0
    # the midplane: cos(theta) == 0, the plane z = 0
    theta_kind[np.abs(cos_tw) < 1e-12] = 2
    cos_tw[np.abs(cos_tw) < 1e-12] = 0.0

    def f(a):
        return torch.as_tensor(np.asarray(a, float), dtype=dtype,
                               device=device)

    return SphericalGeometry(
        rw=f(rw / L), rw2=f((rw / L) ** 2), cos_tw=f(cos_tw),
        cos2_tw=f(cos_tw ** 2),
        theta_kind=torch.as_tensor(theta_kind, device=device),
        sin_pw=f(np.sin(pw)), cos_pw=f(np.cos(pw)), phi_w=f(pw),
        volumes=f(grid.volumes.reshape(-1) / L ** 3),
        # float32 needs a larger exclusion than float64
        t_eps=3e-6 if dtype == torch.float32 else 1e-12,
        n1=len(rw) - 1, n2=len(tw) - 1, n3=len(pw) - 1, length_scale=L)
