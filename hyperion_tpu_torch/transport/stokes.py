"""Polarized scattering of the port (counterpart of
``hyperion_tpu/transport/stokes.py``; ref dust_scatter + scatter_stokes,
src/dust/dust_type_4elem.f90:421-691).

The photon's Stokes vector (I, Q, U, V) lives in the meridian basis
(e_l, e_r) = (e_theta, e_phi) of its direction, with I kept at 1. A
scattering event rotates it into the scattering plane, applies the
4-element matrix P1..P4 at the scattering angle and rotates it into the
outgoing meridian basis, all from the direction vectors. The cosine of the
scattering angle is drawn from the mixture I·P1 + Q_scat·P2 by a bisection
of fixed trips over the unnormalized cumulative tables. The samplers take
their uniforms as arguments."""

import math

import torch

from .sampling import searchsorted_rows


def meridian_frame(kx, ky, kz):
    """(e_l, e_r) = (e_theta, e_phi) of direction k; (x_hat, y_hat) at the
    poles, the reference's default angle convention."""
    st = torch.sqrt(kx * kx + ky * ky)
    safe = st > 1e-12
    one = torch.ones_like(st)
    zero = torch.zeros_like(st)
    inv = torch.where(safe, 1.0 / torch.where(safe, st, one), zero)
    cp = torch.where(safe, kx * inv, one)
    sp = torch.where(safe, ky * inv, zero)
    return (kz * cp, kz * sp, -st), (-sp, cp, zero)


def _rotate_stokes(q, u, cos2, sin2):
    """L(psi) applied to (Q, U): the basis rotated by psi toward e_r."""
    return cos2 * q + sin2 * u, -sin2 * q + cos2 * u


def phase_rows(dt, dust_id, nu):
    """The (dust, frequency bin) row of the scattering tables of each lane:
    the nearest frequency bin below nu."""
    n_nu = dt.nu.shape[1]
    inu = (searchsorted_rows(dt.nu, dust_id, nu) - 1).clamp(0, n_nu - 1)
    return dust_id * n_nu + inu


def _mu_bracket(dt, dust_id, mu):
    """(j, frac): the mu grid interval of each lane's dust that holds mu,
    and mu's place in it, clipped to [0, 1]."""
    n_mu = dt.mu.shape[1]
    j = searchsorted_rows(dt.mu, dust_id, mu).clamp(1, n_mu - 1)
    m0 = dt.mu[dust_id, j - 1]
    m1 = dt.mu[dust_id, j]
    frac = torch.where(m1 > m0, (mu - m0) / (m1 - m0),
                       torch.zeros_like(mu)).clamp(0.0, 1.0)
    return j, frac


def _interp(table, rows, j, frac):
    p0 = table[rows, j - 1]
    return p0 + frac * (table[rows, j] - p0)


def _matrix_at(dt, rows, dust_id, mu):
    """P1..P4 (peel-normalized) at each lane's row and mu."""
    j, frac = _mu_bracket(dt, dust_id, mu)
    return [_interp(t, rows, j, frac)
            for t in (dt.P1_peel, dt.P2_peel, dt.P3_peel, dt.P4_peel)]


def eval_phase_peel(dt, dust_id, nu, mu, rows=None):
    """P1_peel(mu) at each lane (nearest frequency bin, linear in mu): the
    unpolarized peel weight of a scattering (ref imaging.py:516).
    ``rows`` are :func:`phase_rows`, computed here when not given."""
    if rows is None:
        rows = phase_rows(dt, dust_id, nu)
    j, frac = _mu_bracket(dt, dust_id, mu)
    return _interp(dt.P1_peel, rows, j, frac)


def _apply_matrix_and_frames(dt, rows, dust_id, kx, ky, kz, tx, ty, tz,
                             cos_t, q, u, v, nx, ny, nz, cos2p1, sin2p1):
    """R(Theta) then the rotation into the outgoing meridian basis; t is
    the in-plane transverse unit vector at the incoming direction and
    (cos2p1, sin2p1) encode L(psi1)."""
    P1, P2, P3, P4 = _matrix_at(dt, rows, dust_id, cos_t)
    q_s, u_s = _rotate_stokes(q, u, cos2p1, sin2p1)
    # R(Theta) (ref scatter_stokes)
    i1 = P1 * 1.0 + P2 * q_s
    q1 = P2 * 1.0 + P1 * q_s
    u1 = P3 * u_s - P4 * v
    v1 = P4 * u_s + P3 * v
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    el2x = cos_t * tx - sin_t * kx
    el2y = cos_t * ty - sin_t * ky
    el2z = cos_t * tz - sin_t * kz
    # the scattering plane's normal e_r' = k x t
    epx = ky * tz - kz * ty
    epy = kz * tx - kx * tz
    epz = kx * ty - ky * tx
    (elnx, elny, elnz), _ = meridian_frame(nx, ny, nz)
    cosp2 = el2x * elnx + el2y * elny + el2z * elnz
    sinp2 = epx * elnx + epy * elny + epz * elnz
    # renormalize the (cos, sin) pair against float32 drift
    r = torch.sqrt((cosp2 ** 2 + sinp2 ** 2).clamp_min(1e-30))
    cosp2 = cosp2 / r
    sinp2 = sinp2 / r
    cos2p2 = cosp2 * cosp2 - sinp2 * sinp2
    sin2p2 = 2.0 * cosp2 * sinp2
    q2, u2 = _rotate_stokes(q1, u1, cos2p2, sin2p2)
    return i1, q2, u2, v1


def sample_scatter_stokes(dt, dust_id, nu, u_phi, u_mu, kx, ky, kz, q, u, v,
                          rows=None):
    """A polarized scattering from the uniforms ``u_phi`` (the azimuth) and
    ``u_mu`` (the angle). Returns (nkx, nky, nkz, q', u', v') with the
    outgoing Stokes vector renormalized to I = 1; the energy is unchanged,
    the mixture density being exact (ref dust_scatter:566-571)."""
    if rows is None:
        rows = phase_rows(dt, dust_id, nu)
    phi = u_phi * (2.0 * math.pi)
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    # the frame around k (as sampling.rotate_direction)
    st = torch.sqrt((kx * kx + ky * ky).clamp_min(0.0))
    safe = st > 1e-12
    one = torch.ones_like(st)
    zero = torch.zeros_like(st)
    inv_st = torch.where(safe, 1.0 / torch.where(safe, st, one), zero)
    ux = torch.where(safe, ky * inv_st, one)
    uy = torch.where(safe, -kx * inv_st, zero)
    vx = torch.where(safe, kz * kx * inv_st, zero)
    vy = torch.where(safe, kz * ky * inv_st, one)
    vz = torch.where(safe, -st, zero)
    tx = cphi * ux + sphi * vx
    ty = cphi * uy + sphi * vy
    tz = cphi * zero + sphi * vz
    # L(psi1) with psi1 = phi - pi/2
    cos2p1 = -torch.cos(2.0 * phi)
    sin2p1 = -torch.sin(2.0 * phi)
    q_s, _ = _rotate_stokes(q, u, cos2p1, sin2p1)

    # mu from I*P1 + q_s*P2 through the unnormalized cumulatives
    n_mu = dt.mu.shape[1]
    c1, c2 = dt.P1_cum, dt.P2_cum
    tot = c1[rows, n_mu - 1] + q_s * c2[rows, n_mu - 1]
    xi = u_mu * tot
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, n_mu - 1)
    for _ in range(math.ceil(math.log2(max(n_mu, 2))) + 1):
        mid = (lo + hi) // 2
        go_hi = c1[rows, mid] + q_s * c2[rows, mid] < xi
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    j = hi.clamp(1, n_mu - 1)
    v0 = c1[rows, j - 1] + q_s * c2[rows, j - 1]
    v1_ = c1[rows, j] + q_s * c2[rows, j]
    frac = torch.where(v1_ > v0, (xi - v0) / (v1_ - v0),
                       torch.zeros_like(xi)).clamp(0.0, 1.0)
    m0 = dt.mu[dust_id, j - 1]
    cos_t = (m0 + frac * (dt.mu[dust_id, j] - m0)).clamp(-1.0, 1.0)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    nx = sin_t * tx + cos_t * kx
    ny = sin_t * ty + cos_t * ky
    nz = sin_t * tz + cos_t * kz
    norm = torch.rsqrt(nx * nx + ny * ny + nz * nz)
    nx, ny, nz = nx * norm, ny * norm, nz * norm
    i2, q2, u2, v2 = _apply_matrix_and_frames(
        dt, rows, dust_id, kx, ky, kz, tx, ty, tz, cos_t, q, u, v, nx, ny,
        nz, cos2p1, sin2p1)
    inv_i = 1.0 / i2.clamp_min(1e-30)
    return nx, ny, nz, q2 * inv_i, u2 * inv_i, v2 * inv_i


def peel_scatter_stokes(dt, dust_id, nu, kx, ky, kz, q, u, v, rx, ry, rz,
                        rows=None):
    """Stokes peel weights (wI, wQ, wU, wV) toward the direction r, in units
    of 1/4pi (ref dust_scatter_peeloff); wI is the P1 phase value for an
    unpolarized photon."""
    if rows is None:
        rows = phase_rows(dt, dust_id, nu)
    cos_t = (kx * rx + ky * ry + kz * rz).clamp(-1.0, 1.0)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    safe = sin_t > 1e-12
    one = torch.ones_like(sin_t)
    zero = torch.zeros_like(sin_t)
    s_safe = torch.where(safe, sin_t, one)
    # the in-plane transverse direction toward r
    tx = torch.where(safe, (rx - cos_t * kx) / s_safe, zero)
    ty = torch.where(safe, (ry - cos_t * ky) / s_safe, zero)
    tz = torch.where(safe, (rz - cos_t * kz) / s_safe, zero)
    # forward or backward peel: no scattering plane; the u axis of k's
    # frame (the psi rotations cancel for the symmetric matrix)
    st = torch.sqrt((kx * kx + ky * ky).clamp_min(0.0))
    safek = st > 1e-12
    inv_st = torch.where(safek, 1.0 / torch.where(safek, st, one), zero)
    ux = torch.where(safek, ky * inv_st, one)
    uy = torch.where(safek, -kx * inv_st, zero)
    tx = torch.where(safe, tx, ux)
    ty = torch.where(safe, ty, uy)
    tz = torch.where(safe, tz, zero)
    # psi1: the angle of t from e_l(k) toward e_r(k)
    (elx, ely, elz), (erx, ery, erz) = meridian_frame(kx, ky, kz)
    cosp1 = tx * elx + ty * ely + tz * elz
    sinp1 = tx * erx + ty * ery + tz * erz
    r_ = torch.sqrt((cosp1 ** 2 + sinp1 ** 2).clamp_min(1e-30))
    cosp1, sinp1 = cosp1 / r_, sinp1 / r_
    cos2p1 = cosp1 * cosp1 - sinp1 * sinp1
    sin2p1 = 2.0 * cosp1 * sinp1
    return _apply_matrix_and_frames(dt, rows, dust_id, kx, ky, kz, tx, ty,
                                    tz, cos_t, q, u, v, rx, ry, rz, cos2p1,
                                    sin2p1)
