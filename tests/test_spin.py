"""Spin-2 SHT tests: closed-form ₂Y_2m validation and E/B roundtrip."""

import numpy as np
import jax.numpy as jnp
import pytest

from cora_tpu.healpix import spin, pixel


def _Y2(m, th, ph):
    """Closed-form spin-2 harmonics ₂Y_2m (CMB convention)."""
    c, s = np.cos(th), np.sin(th)
    if m == 0:
        return np.sqrt(15 / (32 * np.pi)) * s**2 + 0j
    if m == 1:
        return np.sqrt(5 / (16 * np.pi)) * s * (1 + c) * np.exp(1j * ph)
    if m == 2:
        return np.sqrt(5 / (64 * np.pi)) * (1 + c) ** 2 * np.exp(2j * ph)
    if m == -1:
        return np.sqrt(5 / (16 * np.pi)) * s * (1 - c) * np.exp(-1j * ph)
    if m == -2:
        return np.sqrt(5 / (64 * np.pi)) * (1 - c) ** 2 * np.exp(-2j * ph)


@pytest.fixture(scope="module")
def op16():
    return spin.SpinSHT(16, 20, 2, l_chunk=8)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_synthesis_vs_closed_form(op16, m):
    nside, lmax = 16, 20
    th, ph = pixel.pix2ang(nside, np.arange(pixel.nside2npix(nside)))
    rng = np.random.RandomState(m)
    L = lmax + 1

    e = rng.randn() + 1j * rng.randn()
    if m == 0:
        e = e.real + 0j
    E = np.zeros((L, L), np.complex128)
    B = np.zeros((L, L), np.complex128)
    E[2, m] = e
    Q, U = op16.synthesis(jnp.asarray(E), jnp.asarray(B))
    P = np.asarray(Q) + 1j * np.asarray(U)

    expect = -e * _Y2(m, th, ph)
    if m > 0:
        expect = expect - ((-1) ** m * np.conj(e)) * _Y2(-m, th, ph)
    assert np.abs(P - expect).max() / np.abs(expect).max() < 1e-12


@pytest.mark.slow
def test_eb_roundtrip(op16):
    rng = np.random.RandomState(9)
    L = 21
    E = rng.randn(L, L) + 1j * rng.randn(L, L)
    B = rng.randn(L, L) + 1j * rng.randn(L, L)
    li = np.arange(L)[:, None]
    mi = np.arange(L)[None, :]
    for X in (E, B):
        X[mi > li] = 0
        X[:2] = 0
        X[:, 0] = X[:, 0].real

    Q, U = op16.synthesis(jnp.asarray(E), jnp.asarray(B))
    E2, B2 = op16.analysis(Q, U, 5)
    assert np.abs(np.asarray(E2) - E).max() / np.abs(E).max() < 1e-7
    assert np.abs(np.asarray(B2) - B).max() / np.abs(B).max() < 1e-7


def test_pure_e_has_no_b(op16):
    """Analysis of a pure-E synthesized map must return negligible B."""
    rng = np.random.RandomState(10)
    L = 21
    E = rng.randn(L, L) + 1j * rng.randn(L, L)
    li = np.arange(L)[:, None]
    mi = np.arange(L)[None, :]
    E[mi > li] = 0
    E[:2] = 0
    E[:, 0] = E[:, 0].real
    B = np.zeros((L, L), np.complex128)

    Q, U = op16.synthesis(jnp.asarray(E), jnp.asarray(B))
    E2, B2 = op16.analysis(Q, U, 5)
    assert np.abs(np.asarray(B2)).max() < 1e-7 * np.abs(E).max()


@pytest.mark.slow
def test_spin_cached_mode_matches_scan():
    """Cached f32 spin-Λ tables must reproduce the exact f64 scan mode."""
    from cora_tpu.healpix.spin import SpinSHT

    nside, lmax = 16, 32
    L = lmax + 1
    rng = np.random.RandomState(0)

    def ralm():
        a = np.zeros((L, L), np.complex128)
        for l in range(2, L):
            a[l, 0] = rng.randn()
            a[l, 1 : l + 1] = (rng.randn(l) + 1j * rng.randn(l)) / np.sqrt(2)
        return a

    E, B = ralm(), ralm()
    op_s = SpinSHT(nside, lmax, 2, l_chunk=16)
    op_c = SpinSHT(nside, lmax, 2, l_chunk=16, legendre_mode="cached")
    Qs, Us = (np.asarray(x) for x in op_s.synthesis(jnp.asarray(E), jnp.asarray(B)))
    Qc, Uc = (np.asarray(x) for x in op_c.synthesis(jnp.asarray(E), jnp.asarray(B)))
    scale = np.abs(Qs).max()
    assert np.abs(Qs - Qc).max() < 1e-6 * scale
    assert np.abs(Us - Uc).max() < 1e-6 * scale

    E2, B2 = (np.asarray(x) for x in op_c.analysis(jnp.asarray(Qs), jnp.asarray(Us), 3))
    band = slice(2, 2 * nside)
    assert np.abs(E2[band] - E[band]).max() / np.abs(E[band]).max() < 1e-3


def test_spin_synthesis_grid_matches_pixel():
    """Grid-layout spin synthesis equals the pixel path (device-safe Q/U)."""
    from cora_tpu.healpix.spin import SpinSHT
    from cora_tpu.healpix import pixel

    nside, lmax = 16, 32
    L = lmax + 1
    rng = np.random.RandomState(0)

    def ralm():
        a = np.zeros((L, L), np.complex128)
        for l in range(2, L):
            a[l, 0] = rng.randn()
            a[l, 1 : l + 1] = (rng.randn(l) + 1j * rng.randn(l)) / np.sqrt(2)
        return a

    E, B = ralm(), ralm()
    op = SpinSHT(nside, lmax, 2, l_chunk=16, legendre_mode="cached")
    Q, U = (np.asarray(x) for x in op.synthesis(jnp.asarray(E), jnp.asarray(B)))
    Qg, Ug = (np.asarray(x) for x in op.synthesis_grid(jnp.asarray(E), jnp.asarray(B)))

    info = pixel.ring_info(nside)
    r_of = np.repeat(np.arange(info["theta"].size), info["nphi"])
    j_of = np.arange(12 * nside**2) - info["start"][r_of]
    assert np.abs(Qg[r_of, j_of] - Q).max() < 1e-10 * np.abs(Q).max()
    assert np.abs(Ug[r_of, j_of] - U).max() < 1e-10 * np.abs(Q).max()


@pytest.mark.slow
def test_spin_grid_analysis_roundtrip():
    """Grid-layout spin analysis recovers E/B in the quadrature band."""
    from cora_tpu.healpix.spin import SpinSHT

    nside, lmax = 16, 32
    L = lmax + 1
    rng = np.random.RandomState(1)

    def ralm():
        a = np.zeros((L, L), np.complex128)
        for l in range(2, L):
            a[l, 0] = rng.randn()
            a[l, 1 : l + 1] = (rng.randn(l) + 1j * rng.randn(l)) / np.sqrt(2)
        return a

    E, B = ralm(), ralm()
    op = SpinSHT(nside, lmax, 2, l_chunk=16, legendre_mode="cached")
    Qg, Ug = op.synthesis_grid(jnp.asarray(E), jnp.asarray(B))
    E2, B2 = (np.asarray(x) for x in op.analysis_grid(Qg, Ug, 3))
    band = slice(2, 2 * nside)
    assert np.abs(E2[band] - E[band]).max() / np.abs(E[band]).max() < 1e-3
    assert np.abs(B2[band] - B[band]).max() / np.abs(B[band]).max() < 1e-3


@pytest.mark.slow
def test_ee_bb_spectral_recovery():
    """Per-ℓ χ² EE/BB power-spectrum recovery against cosmic variance.

    The spin-2 twin of the scalar contract (test_skysim.py
    test_mkfullsky_statistics): draw a_lm^E, a_lm^B from known
    C_ℓ^EE/C_ℓ^BB, synthesize (Q, U), analyse back, and require the
    recovered spectra to sit inside exact χ² cosmic-variance bands —
    (2ℓ+1)·ĉ_ℓ/C_ℓ ~ χ²_{2ℓ+1} per realisation.  The reference's pol
    tests assert only physical std bands per Stokes
    (reference tests/test_maps.py:22-58); this is the stronger
    spectral-statistics contract.  Band ℓ ≤ 2·nside where the spin
    analysis round-trip is exact to 1e-3 (see
    test_grid_layout_roundtrip); quadrature bias is negligible against
    the ~1/√(2ℓ+1) cosmic variance.
    """
    import jax

    nside, lmax = 16, 32
    L = lmax + 1
    nreal = 4
    l = np.arange(L, dtype=np.float64)
    clEE = np.where(l < 2, 0.0, (l + 1.0) ** -2.0)
    clBB = np.where(l < 2, 0.0, 0.5 * (l + 1.0) ** -2.2)

    li = np.arange(L)[:, None]
    mi = np.arange(L)[None, :]
    tri = mi <= li

    def draw(rng, cl):
        a = (rng.standard_normal((L, L))
             + 1j * rng.standard_normal((L, L))) * np.sqrt(0.5)
        a[:, 0] = rng.standard_normal(L)
        a = np.where(tri, a, 0.0)
        return a * np.sqrt(cl)[:, None]

    def cl_hat(a):
        w = np.where(mi[0] == 0, 1.0, 2.0)
        return (w * np.abs(a) ** 2).sum(axis=1) / (2 * l + 1)

    op = spin.SpinSHT(nside, lmax, 2, l_chunk=16)
    band = slice(2, 2 * nside + 1)
    lb = l[band]

    rng = np.random.default_rng(12)
    ee, bb, eb = [], [], []
    for r in range(nreal):
        E = draw(rng, clEE)
        B = draw(rng, clBB)
        Q, U = op.synthesis(jnp.asarray(E), jnp.asarray(B))
        E2, B2 = (np.asarray(x) for x in op.analysis(Q, U, 3))
        ee.append(cl_hat(E2))
        bb.append(cl_hat(B2))
        w = np.where(mi[0] == 0, 1.0, 2.0)
        eb.append((w * (E2 * np.conj(B2)).real).sum(axis=1) / (2 * l + 1))
    ee, bb, eb = (np.array(x) for x in (ee, bb, eb))

    for name, meas, cl in [("EE", ee, clEE), ("BB", bb, clBB)]:
        t_per = (2 * lb + 1) * meas[:, band] / cl[band]
        T = t_per.sum()
        N = nreal * (2 * lb + 1).sum()
        z_global = (T - N) / np.sqrt(2 * N)
        assert abs(z_global) < 5.0, (name, z_global)
        k = nreal * (2 * lb + 1)
        z_l = (t_per.sum(axis=0) - k) / np.sqrt(2 * k)
        assert np.abs(z_l).max() < 5.5, (name, z_l)

    # EB cross spectrum: zero-mean with var C_EE·C_BB/(2ℓ+1) per real
    sig = np.sqrt(clEE[band] * clBB[band] / (2 * lb + 1) / nreal)
    z_eb = eb[:, band].mean(axis=0) / sig
    assert np.abs(z_eb).max() < 5.5, z_eb


@pytest.mark.parametrize("spin_", [1, 2])
def test_f32_scan_matches_f64(spin_):
    """The f32 scan (the accelerator path: scaled Wigner-d recurrence with
    f64 checkpoint re-seeding) stays within the 1e-5 map-RMS contract of
    the f64 transform at nside 128, lmax 383.  Unscaled f32 seeds flush
    to zero near the poles there (≈18 % map RMS error)."""
    from cora_tpu.healpix.spin import SpinSHT

    nside, lmax = 128, 383
    L = lmax + 1
    rng = np.random.default_rng(1)
    a = rng.standard_normal((2, L, L)) + 1j * rng.standard_normal((2, L, L))
    a *= (1.0 + np.arange(L))[None, :, None] ** -1.0
    a *= np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    a[..., 0] = a[..., 0].real
    op = SpinSHT(nside, lmax, spin_, l_chunk=64)
    ref = op.synthesis_grid(jnp.asarray(a[0]), jnp.asarray(a[1]))
    got = op.synthesis_grid(jnp.asarray(a[0].astype(np.complex64)),
                            jnp.asarray(a[1].astype(np.complex64)))
    assert got[0].dtype == jnp.float32
    for g, r in zip(got, ref):
        g, r = np.asarray(g, np.float64), np.asarray(r)
        assert np.sqrt(np.mean((g - r) ** 2) / np.mean(r**2)) < 1e-5
