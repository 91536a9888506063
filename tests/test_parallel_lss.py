"""Sharded LSS pipeline equality tests on the 8-device virtual mesh.

Every program in :mod:`cora_tpu.parallel.lss` is checked against its
single-device counterpart — the reference validates its MPI LSS chain
only by running it on a cluster (cora/signal/lss.py:441-474, 806-811,
1202, 1287); here the same data paths run on virtual devices and must
EQUAL the unsharded implementations (tolerance: f64 reduction order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cora_tpu.parallel.mesh import make_mesh
from cora_tpu.parallel import lss as plss
from cora_tpu.signal import lssutil


requires_multi = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def _corr(lmax, n):
    l = np.arange(lmax + 1, dtype=np.float64)
    cl = 1e-6 * (1.0 + l) ** -2.0
    x = np.linspace(0.0, 1.0, n)
    fc = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.1) ** 2)
    return cl[:, None, None] * fc[None]


def _shells(nside, nchi, seed=0, amp=1.0):
    rng = np.random.default_rng(seed)
    npix = 12 * nside**2
    return amp * rng.standard_normal((nchi, npix))


# --- radial stencil matrices -------------------------------------------


def test_gradient_matrix_matches_np_gradient():
    rng = np.random.default_rng(1)
    x = np.cumsum(0.5 + rng.random(12))
    f = rng.standard_normal((12, 7))
    got = lssutil.gradient_matrix(x) @ f
    want = np.gradient(f, x, axis=0)
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_diff2_matrix_matches_diff2():
    rng = np.random.default_rng(2)
    x = np.cumsum(0.5 + rng.random(10))
    f = rng.standard_normal((10, 5))
    got = lssutil.diff2_matrix(x) @ f
    want = lssutil.diff2(f, x, axis=0)
    assert np.allclose(got, want, rtol=1e-10, atol=1e-12)


# --- sharded programs vs single-device ---------------------------------


@requires_multi
def test_initial_lss_sharded_matches_mkfullsky():
    from cora_tpu.core import skysim

    nside, nz = 8, 4
    lmax = 3 * nside - 1
    cla = _corr(lmax, 2 * nz)
    key = jax.random.PRNGKey(3)

    mesh = make_mesh(8)
    sky8 = np.asarray(
        plss.initial_lss_sharded(cla, nside, key, mesh)
    )

    sky1 = np.asarray(skysim.mkfullsky(cla, nside, key=key))

    assert sky8.shape == (2 * nz, 12 * nside**2)
    scale = np.abs(sky1).max()
    assert np.abs(sky8 - sky1).max() < 1e-10 * scale


@requires_multi
def test_gradient_sharded_matches_single_device():
    nside, nchi = 8, 8
    chi = np.linspace(900.0, 1100.0, nchi)
    maps = _shells(nside, nchi, seed=4)

    mesh = make_mesh(8)
    got = np.asarray(plss.gradient_sharded(maps, chi, mesh))
    want = lssutil.gradient(maps, chi, grad0=True)

    assert got.shape == want.shape == (3, nchi, 12 * nside**2)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-8 * scale


@requires_multi
def test_linear_dynamics_sharded_matches_formula():
    nchi, npix = 16, 12 * 4**2
    chi = np.linspace(900.0, 1100.0, nchi)
    rng = np.random.default_rng(5)
    phi = rng.standard_normal((nchi, npix))
    delta = rng.standard_normal((nchi, npix))
    delta_b = rng.standard_normal((nchi, npix))
    D = 0.5 + 0.5 * rng.random(nchi)
    frD = D * (0.4 + 0.2 * rng.random(nchi))

    mesh = make_mesh(8)
    got = np.asarray(
        plss.linear_dynamics_sharded(phi, delta, delta_b, chi, D, frD, mesh)
    )
    want = (
        delta_b
        + D[:, None] * delta
        - frD[:, None] * lssutil.diff2(phi, chi, axis=0)
    )
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()

    # RSD off
    got0 = np.asarray(
        plss.linear_dynamics_sharded(phi, delta, delta_b, chi, D, None, mesh)
    )
    want0 = delta_b + D[:, None] * delta
    assert np.abs(got0 - want0).max() < 1e-12 * np.abs(want0).max()


@requires_multi
def test_fog_sharded_matches_matmul():
    nchi, npix = 16, 12 * 4**2
    rng = np.random.default_rng(6)
    K = rng.standard_normal((nchi, nchi))
    f = rng.standard_normal((nchi, npix))

    mesh = make_mesh(8)
    got = np.asarray(plss.fog_sharded(K, f, mesh))
    want = K @ f
    assert np.abs(got - want).max() < 1e-10 * np.abs(want).max()


@requires_multi
def test_shot_noise_sharded_matches_single_device():
    nchi, npix = 16, 12 * 4**2
    rng = np.random.default_rng(7)
    std = 0.1 + rng.random(nchi)
    key = jax.random.PRNGKey(11)

    mesh8 = make_mesh(8)
    got = np.asarray(
        plss.shot_noise_sharded(key, std, (nchi, npix), mesh8)
    )
    # jax.random bits are a pure function of (key, position): any mesh
    # (incl. trivial) produces the identical field
    mesh1 = make_mesh(1)
    want = np.asarray(
        plss.shot_noise_sharded(key, std, (nchi, npix), mesh1)
    )
    assert np.array_equal(got, want)
    assert got.shape == (nchi, npix)
    # statistics: per-row std matches the requested amplitude
    rs = got.std(axis=1)
    assert np.allclose(rs, std, rtol=0.2)


@requires_multi
@pytest.mark.slow
def test_za_density_sph_sharded_matches_single_device():
    from cora_tpu.ops import pmesh

    nside, nchi = 8, 32
    npix = 12 * nside**2
    chi = np.linspace(900.0, 1000.0, nchi)
    rng = np.random.default_rng(8)
    dchi = float(np.mean(np.diff(chi)))
    # sub-bin displacements: nothing leaves the halo (nloc=4 at 8 dev)
    psi = np.stack([
        0.3 * dchi * rng.standard_normal((nchi, npix)),
        2e-3 * rng.standard_normal((nchi, npix)),
        2e-3 * rng.standard_normal((nchi, npix)),
    ])
    delta_b = 0.1 * rng.standard_normal((nchi, npix))
    delta_m = 0.1 * rng.standard_normal((nchi, npix))

    mesh = make_mesh(8)
    got = np.asarray(
        plss.za_density_sph_sharded(
            psi, delta_b, delta_m, chi, nside, mesh, halo=4
        )
    )
    want = np.asarray(
        pmesh.za_density_sph(
            jnp.asarray(psi), jnp.asarray(delta_b), jnp.asarray(delta_m),
            jnp.asarray(chi), nside,
        )
    )
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-10 * scale


@requires_multi
@pytest.mark.slow
def test_za_density_sph_sharded_arith_geometry_args():
    """Arith-vector sharded deposit with caller-built host geometry.

    This is the nside>=512 configuration: geometry built on host WITHOUT the nn_vec table and
    shipped through the program's jit arguments; neighbour vectors
    computed arithmetically in-graph.  Must equal the single-device
    arith deposit.
    """
    from cora_tpu.ops import pmesh

    nside, nchi = 8, 32
    npix = 12 * nside**2
    chi = np.linspace(900.0, 1000.0, nchi)
    rng = np.random.default_rng(11)
    dchi = float(np.mean(np.diff(chi)))
    psi = np.stack([
        0.3 * dchi * rng.standard_normal((nchi, npix)),
        2e-3 * rng.standard_normal((nchi, npix)),
        2e-3 * rng.standard_normal((nchi, npix)),
    ])
    delta_b = 0.1 * rng.standard_normal((nchi, npix))
    delta_m = 0.1 * rng.standard_normal((nchi, npix))

    geom = pmesh.sph_geometry(nside, device=False, vectors=False)
    assert "nn_vec" not in geom  # the big table is never built

    mesh = make_mesh(8)
    got = np.asarray(
        plss.za_density_sph_sharded(
            psi, delta_b, delta_m, chi, nside, mesh, halo=4,
            vectors="arith", geometry=geom,
        )
    )
    want = np.asarray(
        pmesh.za_density_sph(
            jnp.asarray(psi), jnp.asarray(delta_b), jnp.asarray(delta_m),
            jnp.asarray(chi), nside, vectors="arith",
        )
    )
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-10 * scale


@requires_multi
@pytest.mark.slow
def test_za_density_sph_sharded_poisons_on_halo_overflow():
    nside, nchi = 4, 16
    npix = 12 * nside**2
    chi = np.linspace(900.0, 1000.0, nchi)
    dchi = float(np.mean(np.diff(chi)))
    # radial displacement of ~6 bins >> halo of 1: must poison, never
    # silently drop the mass
    psi = np.zeros((3, nchi, npix))
    psi[0] = 6.0 * dchi
    delta_b = np.zeros((nchi, npix))
    delta_m = np.zeros((nchi, npix))

    mesh = make_mesh(8)
    out = np.asarray(
        plss.za_density_sph_sharded(
            psi, delta_b, delta_m, chi, nside, mesh, halo=1
        )
    )
    assert np.isnan(out).any()


# --- task-level mesh wiring ---------------------------------------------


@requires_multi
@pytest.mark.slow
def test_lss_task_chain_mesh_matches_single_device():
    """Full LSS task chain with mesh_devices=-1 equals the unsharded chain.

    Correlations → C_l → InitialLSS → bias → {Zel'dovich, Linear} →
    FoG — every mesh-wired task runs on all 8 virtual devices and must
    reproduce the single-device chain (the reference validates its MPI
    chain only by running it on a cluster; here equality is asserted).
    Shot noise is checked for mesh-size invariance separately
    (its keyed device RNG intentionally differs from the host stream).
    """
    from cora_tpu.signal import lss

    cc = lss.CalculateCorrelations.from_config({"samples_per_decade": 100})
    cc.setup()
    corr = cc.process()
    aps = lss.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        {"nside": 8, "frequencies": [500.0, 550.0, 8], "xromb": 1}
    ).process(corr)

    def chain(mesh_devices):
        gen = lss.GenerateInitialLSSFromCl.from_config(
            {"num_sims": 1, "start_seed": 1, "mesh_devices": mesh_devices}
        )
        gen.setup(aps)
        init = gen.process()

        bias = lss.GeneratePolynomialBias.from_config({"model": "HI"})
        bias.setup()
        bf = bias.process(init)

        zd = lss.ZeldovichDynamics.from_config(
            {"sph": True, "mesh_devices": mesh_devices}
        )
        za = zd.process(init, bf)

        ld = lss.LinearDynamics.from_config({"mesh_devices": mesh_devices})
        lin = ld.process(init, bf)

        fog = lss.FingersOfGod.from_config(
            {"model": "HI", "mesh_devices": mesh_devices}
        )
        fog.setup()
        sm = fog.process(za)
        return init, za, lin, sm

    i1, z1, l1, s1 = chain(0)
    i8, z8, l8, s8 = chain(-1)

    for a, b, name, tol in [
        (i1.delta, i8.delta, "initial delta", 1e-9),
        (i1.phi, i8.phi, "initial phi", 1e-9),
        (z1.delta, z8.delta, "zeldovich", 1e-7),
        (l1.delta, l8.delta, "linear dynamics", 1e-9),
        (s1.delta, s8.delta, "fog", 1e-9),
    ]:
        scale = max(np.abs(a).max(), 1e-30)
        dev = np.abs(np.asarray(a) - np.asarray(b)).max()
        assert dev < tol * scale, f"{name}: {dev:.3e} vs scale {scale:.3e}"

    # shot noise: the task's mesh path is deterministic in the seed and
    # mesh-size invariant (shot_noise_sharded itself is equality-tested
    # above); here check the task wiring end to end
    base = s8.delta.copy()
    sn8 = lss.AddCorrelatedShotNoise.from_config(
        {"log_M_HI_g": 10.0, "mesh_devices": -1}
    )
    sn8.setup(i8)
    noise8 = sn8.process(s8).delta - base

    s1b = lss.FingersOfGod.from_config({"model": "HI"})
    s1b.setup()
    field1 = s1b.process(z1)
    base1 = field1.delta.copy()
    sn1 = lss.AddCorrelatedShotNoise.from_config(
        {"log_M_HI_g": 10.0, "mesh_devices": -1, "seed": sn8.seed}
    )
    sn1.setup(i1)
    noise1 = sn1.process(field1).delta - base1
    assert np.array_equal(noise8, noise1)
    assert np.isfinite(noise8).all() and noise8.std() > 0


@requires_multi
@pytest.mark.slow
def test_zeldovich_sharded_matches_task_composition():
    """Full sharded ZA step == ZeldovichDynamics.process data path."""
    from cora_tpu.ops import pmesh
    from cora_tpu.healpix import transforms as hputil

    nside, nchi = 8, 16
    npix = 12 * nside**2
    # descending chi (frequency ordering) exercises the host flip
    chi = np.linspace(1100.0, 900.0, nchi)
    rng = np.random.default_rng(9)
    phi = 1e-2 * rng.standard_normal((nchi, npix))
    delta = 0.1 * rng.standard_normal((nchi, npix))
    delta_b = 0.1 * rng.standard_normal((nchi, npix))
    D = 0.5 + 0.5 * rng.random(nchi)
    fr = 0.4 + 0.2 * rng.random(nchi)

    mesh = make_mesh(8)
    got = np.asarray(
        plss.zeldovich_sharded(
            phi, delta, delta_b, chi, D, fr, nside, mesh, halo=2
        )
    )

    # single-device composition exactly as ZeldovichDynamics.process
    # (signal/lss.py:477-511)
    vpsi = lssutil.gradient(phi, chi, grad0=True)
    vpsi *= D[None, :, None]
    theta, _ = hputil.ang_positions(nside).T
    vpsi[1:3] /= chi[None, :, None]
    vpsi[2] /= np.sin(theta[None, :])
    vpsi[0] *= (1 + fr)[:, None]
    delta_m = delta * D[:, None]
    want = np.asarray(
        pmesh.za_density_sph(
            jnp.asarray(vpsi), jnp.asarray(delta_b), jnp.asarray(delta_m),
            jnp.asarray(chi), nside,
        )
    )
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-8 * scale
