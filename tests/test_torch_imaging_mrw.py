"""The imaging step's modified-random-walk branch against the JAX
package's, on the same lanes, cells and uniforms (JAX x64, torch float64),
and the whole imaging iteration with MRW on and off in both packages.

One step of each package's imaging iteration runs on a batch of lanes deep
in thick cells of a spherical-polar and a cylindrical-polar grid, each one
that jumps (n_inter = 1, alpha_inv d_close > gamma), the port fed the
uniforms the JAX step draws from its key. The jumps' positions,
directions and frequencies agree to rtol 1e-12, the cell is the JAX
package's kept cell (the port relocates, and finds the same), the peeled
SED cubes agree to rtol 1e-9, and neither package moves a jumped photon
on in that step.

Then the departure: the JAX step ends every photon's walk at its first
jump (``hyperion_tpu/transport/imaging.py:924`` takes the jumped lanes out
of ``active``, and :1039 builds ``alive`` from ``active``), without
counting it as killed; the port's photon walks on, as the reference's
does (iter_final.f90:167-184: after grid_do_mrw_noenergy the photon
continues its propagation). The whole-run test shows what that costs:
the JAX package's far-infrared light with MRW on falls well below its
own MRW-off run, the witness, while the port's stays with it."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hyperion_tpu.model.run import build_geometry_tables as j_geometry
from hyperion_tpu.transport import build_dust_tables as j_dust
from hyperion_tpu.transport import build_source_tables as j_sources
from hyperion_tpu.transport import imaging as j_img
from hyperion_tpu.transport.lucy import compute_jnu_var as j_jnu_var
from hyperion_tpu.transport.mrw import prepare_mrw_tables as j_mrw
from hyperion_tpu_torch.model.run import build_geometry_tables
from hyperion_tpu_torch.transport import imaging as img
from hyperion_tpu_torch.transport.dtable import build_dust_tables
from hyperion_tpu_torch.transport.engine import update_optical_constants
from hyperion_tpu_torch.transport.mrw import prepare_mrw_tables
from hyperion_tpu_torch.transport.stable import build_source_tables
from test_torch_frontend import frontend
from test_torch_imaging_units import _assert_accums_equal, _groups_both

torch.set_num_threads(1)
CPU = torch.device('cpu')
F64 = torch.float64
RTOL = 1e-12
B = 1500
GAMMA = 2.0


def _grid(package, kind):
    F = frontend(package)
    if kind == 'spherical':
        return F.SphericalPolarGrid(np.hstack([0.0, np.geomspace(0.1, 1, 8)]),
                                    np.linspace(0.0, np.pi, 7),
                                    np.linspace(0.0, 2 * np.pi, 4))
    return F.CylindricalPolarGrid(np.hstack([0.0, np.geomspace(0.1, 1, 8)]),
                                  np.linspace(-1.0, 1.0, 7),
                                  np.linspace(0.0, 2 * np.pi, 4))


def _dust(package):
    nu = np.logspace(8, 17, 40)
    d = frontend(package).HenyeyGreensteinDust(
        nu, np.repeat(0.5, 40), np.repeat(40.0, 40), np.repeat(0.4, 40),
        np.repeat(0.8, 40))
    d.set_lte_emissivities(n_temp=40, temp_min=0.1, temp_max=1600.)
    return d


def _confs(package):
    m = frontend(package).Model()
    c = m.add_peeled_images(sed=True, image=False)
    c.set_viewing_angles([20.0, 60.0, 85.0], [0.0, 30.0, 200.0])
    c.set_wavelength_range(20, 0.5, 2000.0)
    c.set_aperture_radii(1, 2.0, 2.0)
    c.set_track_origin('basic')
    return m.peeled_output


def _uniform(key, n=B):
    return np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float64))


def _mrw_uniforms(key):
    """The port's (N_UNIFORMS, B) uniforms of one imaging step whose MRW
    rows are those the JAX step draws from ``key`` (the other rows feed
    lanes that do not jump: random)."""
    k_step = jax.random.split(key, 12)[0]
    k_m1, k_m2, k_m3, k_m4 = jax.random.split(
        jax.random.fold_in(k_step, 23), 4)
    u = np.random.default_rng(1).random((img.N_UNIFORMS, B))
    for row, k in ((img.U_MRW_JUMP_MU, jax.random.split(k_m1)[0]),
                   (img.U_MRW_JUMP_PHI, jax.random.split(k_m1)[1]),
                   (img.U_MRW_DIR_MU, jax.random.split(k_m2)[0]),
                   (img.U_MRW_DIR_PHI, jax.random.split(k_m2)[1]),
                   (img.U_MRW_DUST, k_m3),
                   (img.U_MRW_BIN, jax.random.split(k_m4)[0]),
                   (img.U_MRW_XI, jax.random.split(k_m4)[1])):
        u[row] = _uniform(k)
    return torch.as_tensor(u)


def _packets(cls, lanes, to):
    """A FinalPacketState of either package from numpy lanes."""
    names = cls._fields if hasattr(cls, '_fields') else \
        [f.name for f in dataclasses.fields(cls)]
    return cls(**{name: to(lanes[name]) for name in names})


@pytest.mark.parametrize('kind', ['spherical', 'cylindrical'])
def test_mrw_step_matches_jax(kind, monkeypatch):
    grids = {p: _grid(p, kind) for p in ('jax', 'port')}
    jg = j_geometry(grids['jax'], jnp.float64)
    pg = build_geometry_tables(grids['port'], CPU, F64)
    jt = j_dust([_dust('jax')], dtype=jnp.float64)
    pt = build_dust_tables([_dust('port')], CPU, F64)
    L = pg.length_scale
    jgr, pgr = _groups_both(_confs('jax'), _confs('port'),
                            j_img.build_peel_group, img.build_peel_group, L)
    src = [frontend(p).PointSource(luminosity=1.0, temperature=5000.0)
           for p in ('jax', 'port')]
    jst = j_sources(src[:1], dtype=jnp.float64, length_scale=L)
    pst = build_source_tables(src[1:], CPU, F64, length_scale=L)
    rng = np.random.default_rng(3)
    n = pg.n_cells
    density = np.full((1, n), 40.0)
    se = 10 ** rng.uniform(-1, 1, (1, n))
    vid, vfrac = j_jnu_var(jt, jnp.asarray(se))
    jm = j_mrw(jt, jnp.asarray(density), jnp.asarray(se), GAMMA, jnp.float64)
    pm = prepare_mrw_tables(pt, torch.as_tensor(density),
                            torch.as_tensor(se), GAMMA)

    # lanes deep in their cells: each jumps
    pos = rng.uniform(-0.8, 0.8, (3, 4 * B))
    mu = rng.uniform(-1, 1, 4 * B)
    az = rng.uniform(0, 2 * np.pi, 4 * B)
    k = np.stack([np.sqrt(1 - mu ** 2) * np.cos(az),
                  np.sqrt(1 - mu ** 2) * np.sin(az), mu])
    tp = [torch.as_tensor(a) for a in (*pos, *k)]
    cell = pg.find_cell(*tp)
    d = pg.closest_wall_distance(cell.clamp_min(0), *tp[:3])
    jumps = (cell >= 0) & (pm.alpha_inv_planck[cell.clamp_min(0)] * d >
                           1.05 * GAMMA)
    sel = np.where(jumps.numpy())[0][:B]
    assert len(sel) == B
    nu = 10 ** rng.uniform(11, 15, B)
    chi, kappa, albedo = (a.numpy() for a in update_optical_constants(
        pt, torch.as_tensor(nu)))
    alive = rng.random(B) < 0.9
    lanes = dict(
        x=pos[0, sel], y=pos[1, sel], z=pos[2, sel], kx=k[0, sel],
        ky=k[1, sel], kz=k[2, sel], nu=nu, energy=rng.uniform(0.5, 2.0, B),
        cell=cell.numpy()[sel], tau=rng.exponential(1.0, B),
        n_inter=np.ones(B, np.int32), n_mrw=rng.integers(0, 3, B),
        n_reabs=np.zeros(B, np.int32), reemit_src=np.full(B, -1),
        alive=alive, reprocessed=rng.random(B) < 0.5,
        scattered=rng.random(B) < 0.5, source_id=np.zeros(B, int),
        dust_id=np.zeros(B, int), n_scat=rng.integers(0, 3, B), chi=chi,
        kappa=kappa, albedo=albedo, q=np.zeros(B), u=np.zeros(B),
        v=np.zeros(B))
    config = dict(n_inter_max=1000000, kill_on_scatter=False,
                  kill_on_absorb=False, forced_first_interaction=False,
                  peeloff_scattering_only=False, ffi_algorithm='wr99',
                  ffi_baes16_xi=0.5, n_reabs_max=0, source_intersect=False,
                  n_mrw_max=1000)

    # the JAX step
    key = jax.random.PRNGKey(17)
    j_step = j_img.make_final_step(jg, jt, jst, jnp.asarray(density), vid,
                                   vfrac, jgr, config, mrw=jm)
    j_acc = [j_img.init_peel_accum(g, jnp.float64) for g in jgr]
    jp = _packets(j_img.FinalPacketState, lanes, jnp.asarray)
    j_out = j_step(dict(packets=jp, key=key, budget=jnp.asarray(0),
                        energy_current=jnp.asarray(0.0), accums=j_acc,
                        binned_acc=None, killed_int=jnp.asarray(0),
                        n_steps=jnp.asarray(0)))
    jq = j_out['packets']

    # the port's step on the same lanes, with the JAX step's MRW uniforms
    p_step = img.make_final_step(pg, pg, pt, pst, torch.as_tensor(density),
                                 torch.as_tensor(np.asarray(vid)),
                                 torch.as_tensor(np.asarray(vfrac)), pgr,
                                 config, mrw=pm)
    carry = img.FinalCarry(
        packets=_packets(img.FinalPacketState, lanes,
                         lambda a: torch.as_tensor(np.asarray(a))),
        budget=0, n_alive=int(alive.sum()), n_pending=0, n_steps=0,
        energy_current=torch.zeros((), dtype=F64),
        accums=[img.PeelAccum(g, CPU, F64) for g in pgr], binned_acc=None,
        killed_int=torch.zeros((), dtype=torch.int64),
        n_events=torch.zeros((), dtype=torch.int64))
    u = _mrw_uniforms(key)
    monkeypatch.setattr(torch, 'rand', lambda *a, **kw: u.clone())
    p_step(carry, None)
    monkeypatch.undo()
    pq = carry.packets

    # the jumps: positions, directions, frequencies (and opacities)
    for f in ('x', 'y', 'z', 'kx', 'ky', 'kz', 'nu', 'chi', 'kappa',
              'albedo'):
        np.testing.assert_allclose(getattr(pq, f).numpy()[alive],
                                   np.asarray(getattr(jq, f))[alive],
                                   rtol=RTOL, atol=1e-15, err_msg=f)
    moved = np.sqrt(sum((getattr(pq, c).numpy() - lanes[c]) ** 2
                        for c in 'xyz'))
    assert (moved[alive] > 0).all() and (moved[~alive] == 0).all()
    # neither moves the photon on in the jump's step: it lies on the jump
    # sphere of radius d_close
    np.testing.assert_allclose(moved[alive], d.numpy()[sel][alive],
                               rtol=1e-12)
    np.testing.assert_array_equal(pq.n_mrw.numpy(),
                                  np.asarray(jq.n_mrw))
    np.testing.assert_array_equal(pq.dust_id.numpy(),
                                  np.asarray(jq.dust_id))
    # the cell: the JAX package keeps it; the port's direction-nudged
    # find_cell gives the same one, but where the landing lies within the
    # nudge of the wall that the jump sphere touches (the cylindrical
    # grid's 1% of its finest wall spacing), where it takes the cell that
    # the new direction points into
    np.testing.assert_array_equal(np.asarray(jq.cell), lanes['cell'])
    other = pq.cell.numpy() != lanes['cell']
    assert other.sum() <= 0.02 * B
    if other.any():
        kept = torch.as_tensor(lanes['cell'][other])
        land = [getattr(pq, c)[torch.as_tensor(other)] for c in 'xyz']
        gap = pg.closest_wall_distance(kept, *land)
        nudge = pg.t_eps * (torch.sqrt(land[0] ** 2 + land[1] ** 2) +
                            land[2].abs()) + pg.eps_floor
        assert kind == 'cylindrical' and (gap <= nudge).all()
    # the isotropic peel at the jump, into every view
    for ja, pa in zip(j_out['accums'], carry.accums):
        _assert_accums_equal(ja, pa)
        assert pa.cubes()['sed'].sum() > 0

    # the departure: the JAX step drops every jumped photon, uncounted;
    # the port's walk goes on
    assert not np.asarray(jq.alive).any()
    assert int(j_out['killed_int']) == 0
    np.testing.assert_array_equal(pq.alive.numpy(), alive)
    assert carry.n_alive == alive.sum()


def _class2_given_se(pkg, mrw, n_imaging):
    """class2_model at 24 x 8 cells with its peeled SEDs, no Lucy
    iteration and a given specific energy (a 300 K (r / 1 au)^-0.5
    profile, as tests/test_torch_mono.py's), MRW on or off."""
    from test_torch_frontend import class2_model
    F = frontend(pkg)
    m = class2_model(pkg, 24, 8, 0, peeled=True, n_imaging=n_imaging)
    m.peeled_output[0].set_uncertainties(True)
    m.set_mrw(mrw, gamma=2.0)
    m.set_n_initial_iterations(0)
    m.evaluate_optically_thin_radii()
    mm = m.to_model()
    g = mm.grid
    r = 0.5 * (g.r_wall[1:] + g.r_wall[:-1])
    temp = np.clip(300.0 * (r / F.au) ** -0.5, 10.0, 1500.0)
    temp = np.broadcast_to(temp[None, None, :], g.shape)
    g.quantities['specific_energy'] = [
        d.temperature2specific_energy(temp) for d in mm._dust_objects()]
    return mm


@pytest.mark.slow
def test_mrw_imaging_light_against_the_mrw_off_witness(tmp_path):
    """class2 at 24 x 8 cells from one given specific energy, 12,000
    imaging photons, MRW on and off in both packages: the light at >= 100
    um (summed over the three views and the band) with MRW on over its own
    MRW-off run (~4 minutes on the CPU, so marked slow). The port's ratio lies within 4 sigma of 1 (sigma from
    both runs' Monte-Carlo uncertainties); the JAX package's falls below
    0.85 and more than 4 sigma below 1, where its imaging step ends each
    photon's walk at its first jump."""
    from hyperion_tpu.model.run import run_model as j_run_model
    from hyperion_tpu_torch.model.run import run_model
    band = {}
    for pkg in ('jax', 'port'):
        for mrw in (False, True):
            m = _class2_given_se(pkg, mrw, 12000)
            path = str(tmp_path / ('%s_%d.rtout' % (pkg, mrw)))
            m.write(path.replace('.rtout', '.rtin'))
            if pkg == 'jax':
                j_run_model(m, path, batch_size=2048)
            else:
                run_model(m, path, device='cpu', batch_size=2048)
            out = frontend('jax').ModelOutput(path)
            val = unc2 = 0.0
            for inc in range(3):
                s = out.get_sed(inclination=inc, aperture=-1,
                                uncertainties=True)
                far = s.wav >= 100.0
                val += s.val[far].sum()
                unc2 += (s.unc[far] ** 2).sum()
            band[pkg, mrw] = (val, np.sqrt(unc2))
    ratio = {}
    for pkg in ('jax', 'port'):
        (off, s_off), (on, s_on) = band[pkg, False], band[pkg, True]
        r = on / off
        ratio[pkg] = (r, r * np.hypot(s_on / on, s_off / off))
    print("MRW on / off at >= 100 um (ratio, sigma):", ratio)
    r, sigma = ratio['port']
    assert abs(r - 1.0) < 4.0 * sigma, ratio
    r, sigma = ratio['jax']
    assert r < 0.85 and r < 1.0 - 4.0 * sigma, ratio
