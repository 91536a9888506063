"""Native SHT tests: synthesis vs scipy spherical harmonics, adjointness,
analysis roundtrip, anafast consistency."""

import numpy as np
import jax.numpy as jnp
import pytest

from cora_tpu.healpix import sht, pixel


@pytest.fixture(scope="module")
def op16():
    return sht.SHT(16, 20, l_chunk=8)


def test_synthesis_vs_scipy(op16):
    """Single-mode synthesis must match scipy's spherical harmonics."""
    from scipy.special import sph_harm_y

    nside, lmax = 16, 20
    th, ph = pixel.pix2ang(nside, np.arange(pixel.nside2npix(nside)))
    rng = np.random.RandomState(0)

    for (l, m) in [(0, 0), (1, 0), (1, 1), (5, 3), (10, 7), (20, 20), (13, 0)]:
        alm = np.zeros((lmax + 1, lmax + 1), dtype=np.complex128)
        c = rng.randn() + 1j * rng.randn()
        if m == 0:
            c = c.real + 0j
        alm[l, m] = c
        mp = np.asarray(op16.synthesis(jnp.asarray(alm)))
        Y = sph_harm_y(l, m, th, ph)
        expect = (c * Y).real if m == 0 else 2 * np.real(c * Y)
        assert np.abs(mp - expect).max() / np.abs(expect).max() < 1e-12


def test_adjointness(op16):
    """Analysis projection must be the exact adjoint of synthesis contraction."""
    rng = np.random.RandomState(1)
    lmax = 20
    nring = 4 * 16 - 1
    alm = rng.randn(lmax + 1, lmax + 1) + 1j * rng.randn(lmax + 1, lmax + 1)
    G = rng.randn(nring, lmax + 1) + 1j * rng.randn(nring, lmax + 1)
    lhs = np.vdot(np.asarray(op16._legendre_contract(jnp.asarray(alm))), G)
    rhs = np.vdot(alm, np.asarray(op16._legendre_project(jnp.asarray(G))))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


def _random_alm(rng, lmax):
    L = lmax + 1
    alm = rng.randn(L, L) + 1j * rng.randn(L, L)
    li = np.arange(L)[:, None]
    mi = np.arange(L)[None, :]
    alm[mi > li] = 0.0
    alm[:, 0] = alm[:, 0].real
    return alm


@pytest.mark.parametrize(
    "nside,lmax,iters,tol",
    [
        (32, 31, 3, 5e-7),
        pytest.param(32, 63, 5, 5e-7, marks=pytest.mark.slow),
    ],
)
def test_roundtrip(nside, lmax, iters, tol):
    """map2alm(alm2map(a)) recovers a for band-limited maps."""
    rng = np.random.RandomState(3)
    op = sht.SHT(nside, lmax)
    alm = _random_alm(rng, lmax)
    m = op.synthesis(jnp.asarray(alm))
    alm2 = np.asarray(op.analysis(m, iters))
    assert np.abs(alm2 - alm).max() / np.abs(alm).max() < tol


def test_batched_synthesis(op16):
    """Batch dims must vectorise identically to per-slice transforms."""
    rng = np.random.RandomState(4)
    lmax = 20
    alms = np.stack([_random_alm(rng, lmax) for _ in range(3)])
    maps = np.asarray(op16.synthesis(jnp.asarray(alms)))
    for i in range(3):
        single = np.asarray(op16.synthesis(jnp.asarray(alms[i])))
        assert np.allclose(maps[i], single)


def test_anafast_flat_spectrum():
    """anafast of a synthesized map recovers the input pseudo-C_l."""
    rng = np.random.RandomState(5)
    nside, lmax = 32, 47
    op = sht.SHT(nside, lmax)
    alm = _random_alm(rng, lmax)
    m = op.synthesis(jnp.asarray(alm))
    cl = np.asarray(sht.anafast(np.asarray(m), lmax=lmax, iter=5))
    # expected pseudo-C_l from the alm themselves
    prod = np.abs(alm) ** 2
    expect = (prod[:, 0] + 2 * prod[:, 1:].sum(axis=1)) / (
        2 * np.arange(lmax + 1) + 1.0
    )
    assert np.abs(cl / expect - 1).max() < 1e-5


def test_parseval(op16):
    """Map variance equals sum of |alm|^2 over 4pi (Parseval)."""
    rng = np.random.RandomState(6)
    alm = _random_alm(rng, 20)
    m = np.asarray(op16.synthesis(jnp.asarray(alm)))
    npix = m.size
    map_power = (m**2).sum() * 4 * np.pi / npix
    alm_power = (np.abs(alm[:, 0]) ** 2).sum() + 2 * (np.abs(alm[:, 1:]) ** 2).sum()
    # HEALPix quadrature is approximate; agreement at the 1e-4 level
    assert abs(map_power / alm_power - 1) < 1e-3


def test_smoothing_reduces_power():
    rng = np.random.RandomState(7)
    nside, lmax = 16, 31
    alm = _random_alm(rng, lmax)
    m = np.asarray(sht.alm2map(jnp.asarray(alm), nside))
    sm = np.asarray(sht.smoothing(m, fwhm=0.3, iter=3))
    assert sm.var() < m.var()
    # the monopole is preserved up to quadrature error
    assert abs(sm.mean() - m.mean()) < 5e-3 * m.std()


def test_smoothing_grid_matches_smoothing():
    """smoothing_grid at full lmax reproduces pixel-path smoothing, and
    supports a leading batch axis."""
    rng = np.random.RandomState(8)
    nside, lmax = 16, 31
    alm = _random_alm(rng, lmax)
    m = np.asarray(sht.alm2map(jnp.asarray(alm), nside))
    ref = np.asarray(sht.smoothing(m, fwhm=0.3, iter=3))
    # smoothing analyses at the full 3·nside−1 band; match it for the
    # equality check (f32 grid path vs f64 pixel path)
    full = 3 * nside - 1
    got = sht.smoothing_grid(m, fwhm=0.3, iter=3, lmax=full)
    assert np.max(np.abs(got - ref)) < 1e-4 * np.std(ref)

    batch = np.stack([m, 2.0 * m])
    gb = sht.smoothing_grid(batch, fwhm=0.3, iter=3, lmax=full)
    assert gb.shape == batch.shape
    assert np.max(np.abs(gb[0] - got)) < 1e-5 * np.std(ref)
    assert np.max(np.abs(gb[1] - 2.0 * got)) < 1e-4 * np.std(ref)

    # beam-limited default band: red-spectrum input, wide beam — the
    # truncated analysis stays within a fraction of the smoothed signal
    red = np.asarray(
        sht.alm2map(jnp.asarray(alm * (1.0 / (1.0 + np.arange(lmax + 1))**2)[:, None]), nside)
    )
    ref_r = np.asarray(sht.smoothing(red, fwhm=0.5, iter=3))
    got_r = sht.smoothing_grid(red, fwhm=0.5, iter=3)
    assert np.max(np.abs(got_r - ref_r)) < 2e-2 * np.std(ref_r)

def test_alm2map_der1():
    """alm2map_der1 returns [f, df/dθ, df/dφ/sinθ] (healpy convention),
    checked against analytic derivatives of Y_10 and Y_11."""
    from scipy.special import sph_harm_y

    nside, lmax = 16, 4
    th, ph = (np.asarray(a) for a in
              pixel.pix2ang(nside, np.arange(pixel.nside2npix(nside))))

    # Y_10 ∝ cosθ: dθ = -N sinθ, dφ = 0
    alm = np.zeros((lmax + 1, lmax + 1), dtype=np.complex128)
    alm[1, 0] = 1.0
    f, dth, dph = np.asarray(sht.alm2map_der1(jnp.asarray(alm), nside))
    N = np.sqrt(3.0 / (4.0 * np.pi))
    assert np.abs(f - N * np.cos(th)).max() < 1e-12
    assert np.abs(dth + N * np.sin(th)).max() < 1e-12
    assert np.abs(dph).max() < 1e-12

    # Y_11 with complex amplitude: checks the φ-derivative sign.
    a = 1.0 + 0.5j
    alm = np.zeros((lmax + 1, lmax + 1), dtype=np.complex128)
    alm[1, 1] = a
    f, dth, dph = np.asarray(sht.alm2map_der1(jnp.asarray(alm), nside))
    Y11 = sph_harm_y(1, 1, th, ph)
    assert np.abs(f - 2 * np.real(a * Y11)).max() < 1e-12
    assert np.abs(dph - 2 * np.real(1j * a * Y11) / np.sin(th)).max() < 1e-12
    c = -np.sqrt(3.0 / (8.0 * np.pi))
    dth_exp = 2 * np.real(a * c * np.cos(th) * np.exp(1j * ph))
    assert np.abs(dth - dth_exp).max() < 1e-12

@pytest.mark.slow
def test_streamed_correlated_synthesis_matches_explicit():
    """The fused streaming draw+synthesis must equal drawing the same alm
    explicitly (same fold_in scheme) and synthesizing."""
    import jax
    from cora_tpu.healpix.sht import SHT, _synthesis_grid, synthesis_grid_correlated

    nside, nz, fchunk = 16, 8, 4
    lmax = 3 * nside - 1
    L = lmax + 1
    op = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm", l_chunk=16)
    t = op.tables(False)
    rng = np.random.RandomState(0)
    roots = jnp.asarray(rng.randn(L, nz, nz).astype(np.float32) * 0.1)
    key = jax.random.PRNGKey(3)

    # replicate the packed-chunk xi scheme: chunk c covers the ells of one
    # parity (evens first), fold_in(key, c) supplies its white noise
    alm = np.zeros((nz, L, L), dtype=np.complex64)
    for c, (parity, sub_lo, nrows, mw_meta) in enumerate(op._lam_meta):
        mw = min(mw_meta, L)
        ells = parity + 2 * (sub_lo + np.arange(nrows))
        kc = jax.random.fold_in(key, c)
        kr, ki = jax.random.split(kc)
        # triangle draw: the library only generates the m < mw columns
        xi = (
            jax.random.normal(kr, (nrows, nz, mw), jnp.float32)
            + 1j * jax.random.normal(ki, (nrows, nz, mw), jnp.float32)
        ) * 0.70710678
        blk = jnp.einsum(
            "lzy,lym->lzm", jnp.asarray(roots)[ells].astype(jnp.complex64), xi
        )
        alm[:, ells, :mw] = np.moveaxis(np.asarray(blk), 0, 1)
    alm = jnp.asarray(alm) * (
        jnp.arange(L)[None, :] <= jnp.arange(L)[:, None]
    )[None, :, :]
    ref = np.asarray(_synthesis_grid(op, t, alm.astype(jnp.complex64)))

    out = np.concatenate(
        [
            np.asarray(synthesis_grid_correlated(op, t, roots, key, i, fchunk))
            for i in range(0, nz, fchunk)
        ],
        axis=0,
    )
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-5


@pytest.mark.slow
def test_split_ring_mode_matches_bluestein():
    """Equatorial fast path must equal the all-Bluestein ring stage."""
    from cora_tpu.healpix.sht import SHT, _synthesis_grid, _grid_to_rings

    nside = 16
    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.RandomState(1)
    alm = (rng.randn(2, L, L) + 1j * rng.randn(2, L, L)) * (
        np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    )
    op_b = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="bluestein")
    op_s = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split")
    tb, ts = op_b.tables(True), op_s.tables(True)
    gb = np.asarray(_synthesis_grid(op_b, tb, jnp.asarray(alm)))
    gs = np.asarray(_synthesis_grid(op_s, ts, jnp.asarray(alm)))
    assert np.abs(gb - gs).max() < 1e-11 * np.abs(gb).max()

    fg = rng.randn(2, op_b.nring, tb["bl_C"].shape[-1])
    Gb = np.asarray(_grid_to_rings(op_b, tb, jnp.asarray(fg), jnp.complex128))
    Gs = np.asarray(_grid_to_rings(op_s, ts, jnp.asarray(fg), jnp.complex128))
    assert np.abs(Gb - Gs).max() < 1e-11 * np.abs(Gb).max()

    # cap-conv sub-batching (HBM-bounding lax.map) must be bit-equivalent
    # up to reduction order
    op_c = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_sub=1)
    tc = op_c.tables(True)
    gc = np.asarray(_synthesis_grid(op_c, tc, jnp.asarray(alm)))
    assert np.abs(gc - gs).max() < 1e-12 * np.abs(gs).max()

    # Karatsuba complex-matmul lowering (3 real dots) must match the XLA
    # 4-dot lowering to rounding; roundtrip analysis too
    op_k = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", fft_cmul="karatsuba")
    tk = op_k.tables(True)
    gk = np.asarray(_synthesis_grid(op_k, tk, jnp.asarray(alm)))
    assert np.abs(gk - gs).max() < 1e-11 * np.abs(gs).max()
    Gk = np.asarray(_grid_to_rings(op_k, tk, jnp.asarray(fg), jnp.complex128))
    assert np.abs(Gk - Gs).max() < 1e-11 * np.abs(Gs).max()


@pytest.mark.slow
def test_analysis_cg_beats_jacobi():
    """CG analysis converges at least as fast as Jacobi refinement."""
    nside, F = 16, 1
    lmax = 2 * nside  # within the quadrature-accurate band
    L = lmax + 1
    rng = np.random.RandomState(2)
    alm = np.zeros((L, L), np.complex128)
    for l in range(1, L):
        alm[l, 0] = rng.randn()
        alm[l, 1 : l + 1] = (rng.randn(l) + 1j * rng.randn(l)) / np.sqrt(2)
    op = sht.SHT(nside, lmax, legendre_mode="cached",
                 cache_dtype=np.float64, fft_mode="mm")
    g = op.synthesis_grid(jnp.asarray(alm))
    ja = np.asarray(op.analysis_grid(g, iter=3))
    cg = np.asarray(op.analysis_grid(g, iter=3, method="cg"))
    err_j = np.linalg.norm(ja[1:] - alm[1:])
    err_c = np.linalg.norm(cg[1:] - alm[1:])
    assert err_c <= err_j * 1.05
    assert err_c / np.linalg.norm(alm[1:]) < 2e-3


@pytest.mark.slow
def test_scan_streamed_correlated_matches_explicit():
    """The Λ-free (scan-mode) streamed draw+synthesis must equal drawing
    the same alm explicitly (consecutive-ℓ fold_in scheme) and
    synthesizing through the scan path."""
    import jax
    from cora_tpu.healpix.sht import SHT, _synthesis_grid, synthesis_grid_correlated

    nside, nz, fchunk = 16, 8, 4
    lmax = 3 * nside - 1
    L = lmax + 1
    op = SHT(nside, lmax, legendre_mode="scan", fft_mode="mm", l_chunk=16,
             scan_ckpt=True)
    t = op.tables(False)
    assert "lam" not in t and "lam_ck" in t
    rng = np.random.RandomState(0)
    roots = jnp.asarray(rng.randn(L, nz, nz).astype(np.float32) * 0.1)
    key = jax.random.PRNGKey(3)

    lc = op.l_chunk
    nchunk = -(-L // lc)
    alm = np.zeros((nz, L, L), dtype=np.complex64)
    for c in range(nchunk):
        l0 = c * lc
        nrows = min(lc, L - l0)
        mw = min(L, ((l0 + nrows + 127) // 128) * 128)
        kc = jax.random.fold_in(key, c)
        kr, ki = jax.random.split(kc)
        xi = (
            jax.random.normal(kr, (nrows, nz, mw), jnp.float32)
            + 1j * jax.random.normal(ki, (nrows, nz, mw), jnp.float32)
        ) * 0.70710678
        blk = jnp.einsum(
            "lzy,lym->lzm",
            jnp.asarray(roots)[l0 : l0 + nrows].astype(jnp.complex64), xi,
        )
        alm[:, l0 : l0 + nrows, :mw] = np.moveaxis(np.asarray(blk), 0, 1)
    alm = jnp.asarray(alm) * (
        jnp.arange(L)[None, :] <= jnp.arange(L)[:, None]
    )[None, :, :]
    ref = np.asarray(_synthesis_grid(op, t, alm.astype(jnp.complex64)))

    out = np.concatenate(
        [
            np.asarray(synthesis_grid_correlated(op, t, roots, key, i, fchunk))
            for i in range(0, nz, fchunk)
        ],
        axis=0,
    )
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-5


@pytest.mark.slow
def test_checkpointed_scan_f32_accuracy():
    """Scaled + checkpointed f32 scan recurrence vs exact f64 scan."""
    from cora_tpu.healpix.sht import SHT, _synthesis_grid

    nside = 64
    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.RandomState(1)
    alm = (rng.randn(1, L, L) + 1j * rng.randn(1, L, L)) * (
        np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    )
    op64 = SHT(nside, lmax, legendre_mode="scan", fft_mode="xla", l_chunk=16)
    g64 = np.asarray(_synthesis_grid(op64, op64.tables(True), jnp.asarray(alm)))[0]
    op32 = SHT(nside, lmax, legendre_mode="scan", fft_mode="xla", l_chunk=16,
               scan_ckpt=True)
    g32 = np.asarray(
        _synthesis_grid(op32, op32.tables(False), jnp.asarray(alm).astype(jnp.complex64))
    )[0]
    nq = op64._nq
    mask = np.zeros(g64.shape, dtype=bool)
    for r in range(op64.nring):
        mask[r, : nq[r]] = True
    d = (g32 - g64)[mask]
    ref = g64[mask]
    rms = float(np.sqrt((d**2).mean()) / np.sqrt((ref**2).mean()))
    assert rms < 1e-5


@pytest.mark.slow
def test_scan_streamed_nondivisible_l_chunk():
    """Scan-streamed correlated synthesis with (lmax+1) % l_chunk != 0.

    Regression: the last ℓ-chunk's dynamic_slice on the covariance roots
    used to clamp to L - l_chunk, contracting valid λ rows against the
    wrong ℓ's roots (order-unity map error at lmax=40 / l_chunk=16)."""
    import jax
    from cora_tpu.healpix.sht import SHT, _synthesis_grid, synthesis_grid_correlated

    nside, nz, fchunk = 16, 4, 2
    lmax = 40  # L = 41: 16 + 16 + 9 — last chunk short
    L = lmax + 1
    op = SHT(nside, lmax, legendre_mode="scan", fft_mode="mm", l_chunk=16)
    t = op.tables(False)
    rng = np.random.RandomState(0)
    roots = jnp.asarray(rng.randn(L, nz, nz).astype(np.float32) * 0.1)
    key = jax.random.PRNGKey(7)

    # explicit alm with the streamed path's RNG scheme: every chunk draws
    # a FULL l_chunk of rows (padded roots beyond L are zero)
    lc = op.l_chunk
    nchunk = -(-L // lc)
    roots_pad = np.zeros((nchunk * lc, nz, nz), np.float32)
    roots_pad[:L] = np.asarray(roots)
    alm = np.zeros((nz, L, L), dtype=np.complex64)
    for c in range(nchunk):
        l0 = c * lc
        mw = min(L, ((min(L, (c + 1) * lc) + 127) // 128) * 128)
        kc = jax.random.fold_in(key, c)
        kr, ki = jax.random.split(kc)
        xi = (
            jax.random.normal(kr, (lc, nz, mw), jnp.float32)
            + 1j * jax.random.normal(ki, (lc, nz, mw), jnp.float32)
        ) * 0.70710678
        blk = jnp.einsum(
            "lzy,lym->lzm",
            jnp.asarray(roots_pad[l0 : l0 + lc]).astype(jnp.complex64), xi,
        )
        nrows = min(lc, L - l0)
        alm[:, l0 : l0 + nrows, :mw] = np.moveaxis(
            np.asarray(blk), 0, 1
        )[:, :nrows]
    alm = jnp.asarray(alm) * (
        jnp.arange(L)[None, :] <= jnp.arange(L)[:, None]
    )[None, :, :]
    ref = np.asarray(_synthesis_grid(op, t, alm.astype(jnp.complex64)))

    out = np.concatenate(
        [
            np.asarray(synthesis_grid_correlated(op, t, roots, key, i, fchunk))
            for i in range(0, nz, fchunk)
        ],
        axis=0,
    )
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 1e-5


def test_mkfullsky_streamed_nondivisible_l_chunk_statistics():
    """End-to-end guard at user-facing level: a flat-C_l sky through the
    streamed scan path at a non-divisible lmax must carry ~the right
    variance (the old clamped slice produced order-unity errors)."""
    import jax
    from cora_tpu.healpix.sht import SHT
    from cora_tpu.core.skysim import mkfullsky_streamed

    nside, nz = 16, 4
    lmax = 40
    L = lmax + 1
    cl = 1e-2 * np.ones(L)
    corr = cl[:, None, None] * np.eye(nz)[None]

    op = SHT(nside, lmax, legendre_mode="scan", fft_mode="mm", l_chunk=16)
    parts = [
        m
        for _, m in mkfullsky_streamed(
            corr, nside, key=jax.random.PRNGKey(2), fchunk=nz, op=op
        )
    ]
    sky = np.concatenate(parts, axis=0)
    # expected map variance: sum_l (2l+1) C_l / 4pi
    var_exp = ((2 * np.arange(L) + 1) * cl).sum() / (4 * np.pi)
    var = sky.var()
    assert 0.5 * var_exp < var < 1.5 * var_exp


@pytest.mark.slow
def test_checkpointed_scan_banded_ckpt_every():
    """ckpt_every > 1 (banded) checkpoint re-seeding in the DENSE scan
    paths, incl. a band count that does not divide the chunk count.

    Regression: checkpoints were silently skipped for ckpt_every != 1, so
    nside>=1024 dense transforms ran the plain recurrence."""
    from cora_tpu.healpix.sht import SHT, _synthesis_grid

    nside = 64
    lmax = 3 * nside - 1
    L = lmax + 1  # 192 = 28*6 + 24: nchunk=7, bands of 2 -> pad to 8
    rng = np.random.RandomState(3)
    alm = (rng.randn(1, L, L) + 1j * rng.randn(1, L, L)) * (
        np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    )
    op64 = SHT(nside, lmax, legendre_mode="scan", fft_mode="xla", l_chunk=28)
    t64 = op64.tables(True)
    g64 = np.asarray(_synthesis_grid(op64, t64, jnp.asarray(alm)))[0]
    op32 = SHT(nside, lmax, legendre_mode="scan", fft_mode="xla", l_chunk=28,
               scan_ckpt=True, ckpt_every=2)
    t32 = op32.tables(False)
    assert "lam_ck" in t32 and t32["lam_ck"].shape[0] == 4  # ceil(7/2)
    g32 = np.asarray(
        _synthesis_grid(op32, t32, jnp.asarray(alm).astype(jnp.complex64))
    )[0]
    nq = op64._nq
    mask = np.zeros(g64.shape, dtype=bool)
    for r in range(op64.nring):
        mask[r, : nq[r]] = True
    d = (g32 - g64)[mask]
    rms = float(np.sqrt((d**2).mean()) / np.sqrt((g64[mask] ** 2).mean()))
    assert rms < 1e-5

    # adjoint (project) path gets the same banded re-seeding
    G64 = op64._legendre_contract(jnp.asarray(alm))
    a64 = np.asarray(op64._legendre_project(G64.astype(jnp.complex128)))
    a32 = np.asarray(op32._legendre_project(G64.astype(jnp.complex64)))
    scale = np.sqrt((np.abs(a64) ** 2).mean())
    # f32 error grows with the re-seed spacing l_chunk*ckpt_every (56 here
    # vs 16 in test_checkpointed_scan_f32_accuracy) — bound scales with it
    assert np.sqrt((np.abs(a32 - a64) ** 2).mean()) / scale < 5e-5


@pytest.mark.slow
def test_analysis_cg_scan_mode_full_lmax():
    """CG analysis in scan Legendre mode, full lmax = 3*nside - 1.

    Two regressions: (1) jax.scipy.sparse.linalg.cg failed to trace the
    lax.scan Legendre operator on jax 0.8 (hand-rolled fori_loop CG now);
    (2) un-guarded CG diverged violently once the residual hit rounding
    level — with the guard, extra iterations are free.  Full-lmax
    map2alm round-trip converges to near machine precision (the corner
    modes need tens of iterations; healpy's Jacobi refinement cannot
    recover them at all)."""
    nside = 16
    lmax = 3 * nside - 1
    rng = np.random.RandomState(5)
    alm = _random_alm(rng, lmax)
    op = sht.SHT(nside, lmax, legendre_mode="scan", fft_mode="xla")
    g = op.synthesis_grid(jnp.asarray(alm))
    a60 = np.asarray(op.analysis_grid(g, iter=60, method="cg"))
    rel = np.linalg.norm(a60 - alm) / np.linalg.norm(alm)
    assert rel < 1e-8
    # over-iterating far past convergence must not destabilize
    a150 = np.asarray(op.analysis_grid(g, iter=150, method="cg"))
    rel150 = np.linalg.norm(a150 - alm) / np.linalg.norm(alm)
    assert rel150 < 1e-10


def _banded_cap_ops():
    from cora_tpu.healpix.sht import SHT

    nside = 32
    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.RandomState(3)
    alm = (rng.randn(2, L, L) + 1j * rng.randn(2, L, L)) * (
        np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    )
    op_d = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_bands=0)
    op_b = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_bands=4)
    return op_d, op_b, alm, L


def test_banded_cap_synthesis_matches_dense():
    """Banded cap Bluestein (per-band conv sizes + m-truncation) must
    match the single-size cap convolution for real synthesis — the
    fast-tier banding check (the complex/analysis/cap_sub paths compile
    another four f64 programs and run --runslow).  m-truncation only
    drops columns where lambda_lm ~ 0, so the agreement bound is the
    truncation epsilon, not machine precision."""
    from cora_tpu.healpix.sht import _synthesis_grid

    op_d, op_b, alm, L = _banded_cap_ops()
    assert op_b._cap_bands is not None and len(op_b._cap_bands) >= 2
    # at least one band must actually truncate m for the test to bite
    assert any(M < L for (_, _, M, _, _) in op_b._cap_bands)
    td, tb = op_d.tables(True), op_b.tables(True)
    gd = np.asarray(_synthesis_grid(op_d, td, jnp.asarray(alm)))
    gb = np.asarray(_synthesis_grid(op_b, tb, jnp.asarray(alm)))
    assert np.abs(gb - gd).max() < 1e-6 * np.abs(gd).max()


@pytest.mark.slow
def test_banded_cap_conv_matches_dense():
    """Banded cap Bluestein vs dense on the remaining paths: complex
    synthesis, analysis adjoint, cap-conv sub-batching."""
    from cora_tpu.healpix.sht import (
        SHT,
        _analysis_once_grid,
        _legendre_contract_cached,
        _rings_to_grid_complex,
        _synthesis_grid,
    )

    nside = 32
    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.RandomState(3)
    alm = (rng.randn(2, L, L) + 1j * rng.randn(2, L, L)) * (
        np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    )
    op_d = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_bands=0)
    op_b = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_bands=4)
    assert op_b._cap_bands is not None and len(op_b._cap_bands) >= 2
    # at least one band must actually truncate m for the test to bite
    assert any(M < L for (_, _, M, _, _) in op_b._cap_bands)
    td, tb = op_d.tables(True), op_b.tables(True)

    gd = np.asarray(_synthesis_grid(op_d, td, jnp.asarray(alm)))
    gb = np.asarray(_synthesis_grid(op_b, tb, jnp.asarray(alm)))
    assert np.abs(gb - gd).max() < 1e-6 * np.abs(gd).max()

    # complex ring evaluation (the spin-weighted building block)
    G = _legendre_contract_cached(op_d, td, jnp.asarray(alm))
    Sd = np.asarray(_rings_to_grid_complex(op_d, td, G))
    Sb = np.asarray(_rings_to_grid_complex(op_b, tb, G))
    assert np.abs(Sb - Sd).max() < 1e-6 * np.abs(Sd).max()

    # analysis end-to-end (banded adjoint feeds the Legendre projection)
    ad = np.asarray(
        _analysis_once_grid(op_d, td, jnp.asarray(gd), jnp.complex128)
    )
    ab = np.asarray(
        _analysis_once_grid(op_b, tb, jnp.asarray(gd), jnp.complex128)
    )
    assert np.abs(ab - ad).max() < 1e-6 * np.abs(ad).max()

    # cap-conv sub-batching composes with banding
    op_s = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
               ring_mode="split", cap_bands=4, cap_sub=1)
    ts = op_s.tables(True)
    gs = np.asarray(_synthesis_grid(op_s, ts, jnp.asarray(alm)))
    assert np.abs(gs - gb).max() < 1e-12 * np.abs(gb).max()


@pytest.mark.slow
def test_pixel_layout_cg_analysis():
    """map2alm(method="cg") from HEALPix pixel ordering: machine-precision
    round trip for a band-limited map, matching the grid-layout CG."""
    from cora_tpu.healpix.sht import map2alm, alm2map

    nside = 8
    lmax = 2 * nside
    rng = np.random.RandomState(7)
    alm = _random_alm(rng, lmax)
    m = alm2map(jnp.asarray(alm), nside)
    a_cg = np.asarray(map2alm(m, lmax, iter=12, method="cg"))
    a_ja = np.asarray(map2alm(m, lmax, iter=3))
    err_cg = np.linalg.norm(a_cg[1:] - alm[1:]) / np.linalg.norm(alm[1:])
    err_ja = np.linalg.norm(a_ja[1:] - alm[1:]) / np.linalg.norm(alm[1:])
    assert err_cg < 1e-12
    assert err_cg < err_ja


@pytest.mark.slow
def test_lambda_device_build_matches_host():
    """lambda_build="device" (on-accelerator Λ materialisation via the
    scaled+checkpointed recurrence) matches the host f64-built chunks to
    the scan-mode accuracy class, including non-divisible L tails.

    Slow tier: compiling the checkpointed device-Λ builder on a 1-core
    CPU box alone exceeds 10 minutes (it is instant-class on real
    accelerators); the default tier must stay runnable there.
    """
    from cora_tpu.healpix.sht import SHT

    for nside, lmax, lc in [(16, 47, 8), (16, 40, 8)]:
        op_h = SHT(nside, lmax, l_chunk=lc, legendre_mode="cached")
        op_d = SHT(nside, lmax, l_chunk=lc, legendre_mode="cached",
                   lambda_build="device")
        th, td = op_h.tables(False), op_d.tables(False)
        for a, b in zip(th["lam"], td["lam"]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape
            assert np.abs(a - b).max() < 5e-6 * np.abs(a).max()

        rng = np.random.RandomState(3)
        alm = _random_alm(rng, lmax).astype(np.complex64)
        m_h = np.asarray(op_h.synthesis(jnp.asarray(alm)))
        m_d = np.asarray(op_d.synthesis(jnp.asarray(alm)))
        rms = np.sqrt(np.mean((m_h - m_d) ** 2) / np.mean(m_h**2))
        assert rms < 3e-6  # within the 1e-5 map contract with margin


@pytest.mark.slow
def test_map2alm_banded_solve():
    """solve_lmax: banded CG + quadrature corner completion.

    The grid determines alm only to ell ~ 2 nside (per-m cond reaches
    1e26 at full lmax — tools/pinv_analysis_proto.py); the banded
    two-stage solve recovers band modes to the pipeline's eps class
    where the full-lmax solve pollutes them ~1e-3 in ANY precision.
    """
    import numpy as np

    nside = 32
    lmaxF = 3 * nside - 1
    L2 = 2 * nside
    Lf = lmaxF + 1
    rng = np.random.default_rng(7)
    li = np.arange(Lf)[:, None]
    mi = np.arange(Lf)[None, :]
    a = (rng.standard_normal((Lf, Lf))
         + 1j * rng.standard_normal((Lf, Lf))) * np.sqrt(0.5)
    a[:, 0] = rng.standard_normal(Lf)
    alm = np.where((mi <= li) & (li <= L2), a, 0.0)
    scale = np.abs(alm).max()

    m64 = np.asarray(sht.alm2map(jnp.asarray(alm), nside))

    # f32 pipeline: banded solve keeps band modes at ~1e-6 (the
    # full-lmax f32 solve sits at ~2e-3 on the same modes)
    rec32 = np.asarray(sht.map2alm(
        m64.astype(np.float32), lmaxF, iter=20, solve_lmax=L2
    ))
    band = (li <= L2) & (mi <= li)
    err32 = np.abs(rec32 - alm)[band].max() / scale
    assert err32 < 5e-6, err32

    full32 = np.asarray(sht.map2alm(
        m64.astype(np.float32), lmaxF, iter=20, method="cg"
    ))
    errf = np.abs(full32 - alm)[band].max() / scale
    assert errf > 10 * err32  # banded strictly beats full-lmax solve

    # f64 pipeline: banded solve reaches ~1e-12
    rec64 = np.asarray(sht.map2alm(m64, lmaxF, iter=20, solve_lmax=L2))
    err64 = np.abs(rec64 - alm)[band].max() / scale
    assert err64 < 1e-11, err64

    # output shape covers the full triangle; corner rows are the
    # quadrature estimate (finite, information-limited)
    assert rec32.shape == (Lf, Lf)
    assert np.isfinite(rec32).all()


@pytest.mark.parametrize(
    "nside,cap_bands",
    [
        (16, 0),
        # the banded case overlaps test_banded_cap_conv_matches_dense's
        # coverage and needs nside >= 32 (banding gate) — slow tier to
        # keep the default tier runnable on a 1-core box
        pytest.param(32, 4, marks=pytest.mark.slow),
    ],
)
def test_rings_to_grid_parity_matches_expand(nside, cap_bands):
    """Parity ring synthesis (transforms on the half-size even/odd
    accumulators, N/S mirror as an output add/sub) == expand + split ring
    stage, to f32 reduction order.  Exercises both the dense-cap and the
    banded-cap forms."""
    from cora_tpu.healpix.sht import (
        SHT, _expand_rings, _rings_to_grid, _rings_to_grid_parity)

    lmax = 3 * nside - 1
    op = SHT(nside, lmax, legendre_mode="cached", fft_mode="mm",
             l_chunk=16, ring_mode="split", cap_bands=cap_bands)
    t = op.tables(False)
    assert op._ns_symmetric

    rng = np.random.default_rng(1)
    nh, L = op.nhalf, lmax + 1
    Ge = (rng.standard_normal((3, nh, L))
          + 1j * rng.standard_normal((3, nh, L))).astype(np.complex64)
    Go = (rng.standard_normal((3, nh, L))
          + 1j * rng.standard_normal((3, nh, L))).astype(np.complex64)
    Ge, Go = jnp.asarray(Ge), jnp.asarray(Go)

    ref = np.asarray(_rings_to_grid(op, t, _expand_rings(op, t, Ge, Go)))
    new = np.asarray(_rings_to_grid_parity(op, t, Ge, Go))
    assert new.shape == ref.shape
    assert np.abs(new - ref).max() < 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize(
    "ring_mode,cap_bands,nside",
    [
        # the dense case covers the ADVICE-r4 regression (fused-conv
        # dense complex synthesis); each extra case costs ~30 s of
        # 1-core compiles, so the split and banded cases run --runslow
        ("dense", 0, 8),
        pytest.param("split", 0, 8, marks=pytest.mark.slow),
        # banding activates only at nside >= 32: the banded-fused paths
        # (fftB conv families) get their equality check in the slow tier
        pytest.param("split", 4, 32, marks=pytest.mark.slow),
    ],
)
def test_fused_conv_matches_twostep(ring_mode, cap_bands, nside):
    """conv_mode="fused" (transpose-free four-step Bluestein convolution,
    fftmm.conv_apply) == conv_mode="twostep" (forward → kernel multiply →
    inverse) on every ring-transform path: real synthesis/analysis, the
    dense ring grid, and the complex fold paths the spin engine reuses.

    Replaces the ring FFT pair of healpy alm2map/map2alm
    (/root/reference/cora/util/hputil.py:388,229) — the fused layout
    eliminates the digit-reversal HBM passes between the paired DFTs.
    """
    from cora_tpu.healpix.sht import (
        SHT, _rings_to_complex, _map_to_rings, _rings_to_grid_complex,
    )

    lmax = 3 * nside - 1
    L = lmax + 1
    rng = np.random.default_rng(7)
    alm = rng.standard_normal((2, L, L)) + 1j * rng.standard_normal((2, L, L))
    for l in range(L):
        alm[:, l, l + 1:] = 0.0
    alm[:, :, 0] = alm[:, :, 0].real
    alm = jnp.asarray(alm)

    ops = {
        cm: SHT(nside, lmax, fft_mode="mm", ring_mode=ring_mode,
                legendre_mode="scan", conv_mode=cm, cap_bands=cap_bands,
                l_chunk=8)
        for cm in ("twostep", "fused")
    }
    nring, npix = ops["fused"].nring, ops["fused"].npix
    G = jnp.asarray(
        rng.standard_normal((2, nring, L))
        + 1j * rng.standard_normal((2, nring, L))
    )
    fmap = jnp.asarray(rng.standard_normal((2, npix)))

    res = {}
    for cm, op in ops.items():
        t = op.tables(double=True)
        m = op.synthesis(alm)
        res[cm] = dict(
            synth=np.asarray(m),
            alm=np.asarray(op.analysis(m, 3)),
            sgrid=np.asarray(op.synthesis_grid(alm)),
            r2c=np.asarray(_rings_to_complex(op, t, G)),
            r2gc=np.asarray(_rings_to_grid_complex(op, t, G)),
            m2r=np.asarray(_map_to_rings(op, t, fmap, jnp.complex128)),
        )
    for k, ref in res["twostep"].items():
        d = np.abs(res["fused"][k] - ref).max()
        assert d < 1e-12 * np.abs(ref).max(), (k, d)


def test_unrolled_lam_scan_matches_single_row():
    """_lam_scan_rows (R ℓ-rows per scan step, rescale checks deferred to
    every 4th row) == the one-row-per-step
    scan with per-row rescale.  In f64 the deferred-rescale emission
    differences are < 2^-250 and XLA FMA-fusion choices dominate, so the
    agreement bound is machine-rounding class."""
    import jax

    from cora_tpu.healpix import sht as S

    nside, lmax = 8, 23
    L = lmax + 1
    rng = np.random.default_rng(5)
    alm = rng.standard_normal((2, L, L)) + 1j * rng.standard_normal((2, L, L))
    for l in range(L):
        alm[:, l, l + 1:] = 0.0
    alm[:, :, 0] = alm[:, :, 0].real
    alm = jnp.asarray(alm)

    op = S.SHT(nside, lmax, fft_mode="mm", legendre_mode="scan",
               l_chunk=8, scan_ckpt=False)
    op.tables(double=True)
    m_unroll = np.asarray(op.synthesis(alm))

    orig = S._lam_scan_rows
    S._lam_scan_rows = (
        lambda l_step, carry, aa, bb: jax.lax.scan(l_step, carry, (aa, bb))
    )
    try:
        jax.clear_caches()
        m_ref = np.asarray(op.synthesis(alm))
    finally:
        S._lam_scan_rows = orig
        jax.clear_caches()

    assert np.abs(m_unroll - m_ref).max() < 1e-11 * np.abs(m_ref).max()


def test_scan_checkpoints_exact_beyond_f64_seed_range():
    """Host checkpoint rows stay exact where the λ_mm seeds fall below the
    f64 range (log2 λ_mm < -1022 near the poles at lmax ≳ 2000).

    Unscaled f64 seeds there flush to zero or to imprecise subnormals
    although their columns grow back to O(1) within the band; the scaled
    host recurrence must match the scaled f64 device recurrence on every
    entry the device scan would take from the checkpoint (|λ| > 2^-20)."""
    import jax

    nside, lmax, lc = 8, 2047, 64
    op = sht.SHT(nside, lmax, legendre_mode="scan", l_chunk=lc,
                 scan_ckpt=True)
    assert op._log2_lam_mm.min() < -1100  # the case under test
    ck = op._build_scan_checkpoints()  # [nchunk, 2, nh, L] f32

    t = op.tables(double=True)
    L = lmax + 1
    l_step = sht._scaled_lam_step(t["lam_mm"], t["lam_k0"], t["z_half"],
                                  jnp.arange(L))
    lam0 = jnp.zeros((op.nhalf, L))
    _, rows = jax.lax.scan(l_step, (lam0, lam0, lam0, jnp.asarray(0)),
                           (t["rec_a"], t["rec_b"]))
    rows = np.asarray(rows)  # [L, nh, L] true λ rows
    for c in range(1, ck.shape[0]):
        for i, l in enumerate((c * lc - 2, c * lc - 1)):
            ref = rows[l]
            use = np.abs(ref) > 2.0**-20
            assert use.any()
            err = np.abs(ck[c, i] - ref)[use] / np.abs(ref)[use]
            assert err.max() < 1e-6, (c, i, err.max())
