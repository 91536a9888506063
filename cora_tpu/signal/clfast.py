"""Device-side C_l(nu, nu') evaluation — the accelerator quadrature path.

The reference computes channel-integrated C_l by Romberg-oversampling the
angular power spectrum in redshift (17× more aps evaluations per channel
pair at the default oversample=3; skysim.py:40-69).  That design is hostile
to accelerators: at Nside=512 × 256 channels it needs ~3e13 table lookups.

The device redesign folds the channel window into the *kpar* direction
of the DCT lookup table instead: multiplying P(kperp, kpar) by
sinc²(kpar·W/2π) before the DCT performs exact top-hat averaging over a
radial width W — the same mechanism the reference exposes as
``_freq_window`` (corr.py:889-932) but never uses in the synthesis path.
With the window baked into the table, the channel-integrated C_l grid costs
exactly one bilinear gather per (l, nu, nu') triple and runs as a single
jitted program on-device: 1536×256² evaluations in milliseconds.

The window width W = |dχ/dν|·Δν varies by ~2.5× across a 2:1 band, so a
single band-centre W is NOT sub-percent (measured: 19% on the diagonal
C_l at the 800 MHz edge of a 400-800 MHz 64-channel band, l=128, vs the
reference's Romberg channel integration).  The default ``window="exact"``
mode therefore uses per-channel widths with no approximation in W:

    sinc(W1 k/2π)·sinc(W2 k/2π) = [cos(k(a-b)) - cos(k(a+b))]/(2 k² a b),
    a = W1/2, b = W2/2,

so the windowed kpar integral is a 4-point combination of
K(r) = ∫dk P(k)/k²(1-cos kr), whose second derivative is the unwindowed
DCT table I(r):

    C(r; a, b) = [K(r+a+b) + K(|r-a-b|) - K(r+a-b) - K(|r-a+b|)]/(4ab).

K is built once host-side as the (affine-part-removed, hence decaying)
double reverse-cumulative integral of I over the existing rpar grid —
same table size, 4 bilinear gathers per (l, ν, ν') instead of 1, exact
per-channel-pair top-hat windows.  Validated against
``skysim.clarray(zromb=3)`` on the 64-channel 2:1 band in
tests/test_skysim.py (sub-percent everywhere).

``window="centre"`` keeps the old single-width behaviour for comparison;
``window="none"`` (or freq_width=0) disables channel integration.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants


def _double_antiderivative(I, dr):
    """(K̃, β) rows from DCT rows: K̃(r) = ∫_r^rmax (s-r)·I(s) ds.

    K̃ is K(r) = ∫_0^r (r-s) I(s) ds with its affine part -β·r + γ removed
    (β = ∫_0^rmax I), so it decays toward zero at large r and stays
    representable in float32.  Two reverse cumulative trapezoids:
    T(r) = ∫_r^rmax I, then K̃(r) = ∫_r^rmax T.

    The affine part cancels in the 4-point combination only while no
    |r ± a ∓ b| argument folds at zero; the evaluators restore it in
    closed form as 2β·(max(r, a+b) - max(r, |a-b|)), which needs β.
    """

    # Chunked over rows with bounded temporaries: the tables are ~131 MB
    # each and fresh page faults are expensive on some virtualised hosts.
    def rev_cumtrapz(a, out):
        for i0 in range(0, a.shape[0], 32):
            sl = slice(i0, min(i0 + 32, a.shape[0]))
            inc = 0.5 * dr * (a[sl, 1:] + a[sl, :-1])
            out[sl, :-1] = np.cumsum(inc[:, ::-1], axis=-1)[:, ::-1]
            out[sl, -1] = 0.0
        return out

    T = rev_cumtrapz(I, _scratch_like(I))
    K = rev_cumtrapz(T, np.empty_like(I))
    return K, T[..., 0].copy()


_SCRATCH = {}


def _scratch_like(a):
    """Shared scratch buffer (per shape/dtype) — contents are transient."""
    key = (a.shape, a.dtype.str)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = np.empty_like(a)
        _SCRATCH[key] = buf
    return buf


def build_cl_tables(model, freqs, freq_width=None, dtype=np.float32,
                    window="exact"):
    """Precompute device tables for fast C_l evaluation of a 21cm-like model.

    Parameters
    ----------
    model : Corr21cm-like
        Must provide ps_vv, cosmology, growth_factor/rate, bias_z,
        prefactor, ps_redshift and the DCT grid parameters.
    freqs : array
        Channel centre frequencies in MHz.
    freq_width : float, optional
        Channel width in MHz (default: spacing of the first two channels).
    window : {"exact", "centre", "none"}
        "exact": per-channel top-hat widths via the 4-point K̃ lookup
        (module docstring) — the default and the accuracy-validated path.
        "centre": single band-centre width baked into the DCT (legacy;
        up to ~19% off at the edges of a 2:1 band).
        "none": no channel integration.

    Returns
    -------
    dict of host numpy arrays: dd/dv/vv tables and per-channel vectors
    (device_put them for the on-device cl_grid path).
    """
    z, chi, Wi, window, W = _channel_state(model, freqs, freq_width, window)

    if window == "exact":
        old_window = model._freq_window
        old_cache = model._aps_cache
        model._freq_window = 0.0
        model._aps_cache = False
        model._build_fft_cache()
        dr = np.pi / model._kparmax
        Kdd, bdd = _double_antiderivative(model._aps_dd, dr)
        Kdv, bdv = _double_antiderivative(model._aps_dv, dr)
        Kvv, bvv = _double_antiderivative(model._aps_vv, dr)
        tables = dict(
            dd=Kdd.astype(dtype, copy=False),
            dv=Kdv.astype(dtype, copy=False),
            vv=Kvv.astype(dtype, copy=False),
            beta_dd=bdd.astype(dtype, copy=False),
            beta_dv=bdv.astype(dtype, copy=False),
            beta_vv=bvv.astype(dtype, copy=False),
            a=(Wi / 2.0).astype(dtype, copy=False),
        )
        model._freq_window = old_window
        model._aps_cache = old_cache
        if old_cache:
            model._build_fft_cache()
    else:
        # Build the DCT tables with the sinc² channel window baked in.
        old_window = model._freq_window
        old_cache = model._aps_cache
        model._freq_window = W
        model._aps_cache = False
        model._build_fft_cache()
        tables = dict(
            dd=model._aps_dd.astype(dtype, copy=False),
            dv=model._aps_dv.astype(dtype, copy=False),
            vv=model._aps_vv.astype(dtype, copy=False),
        )
        model._freq_window = old_window
        model._aps_cache = old_cache
        if old_cache:
            model._build_fft_cache()

    for k, v in _channel_vectors(model, z, chi).items():
        tables[k] = v.astype(dtype, copy=False)
    return tables


def _channel_state(model, freqs, freq_width, window):
    """Resolve the channel grid.

    Returns ``(z, chi, Wi, window, W)``: redshifts, comoving distances,
    per-channel comoving widths (``None`` unless window == "exact"), the
    resolved window mode, and the band-centre comoving width ``W`` used by
    the legacy "centre" mode (0.0 otherwise).
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    if freq_width is None:
        freq_width = np.abs(freqs[1] - freqs[0])
    if freq_width == 0.0:
        window = "none"

    z = constants.nu21 / freqs - 1.0
    chi = model.cosmology.comoving_distance(z)

    Wi = None
    if window == "exact":
        # per-channel radial widths: the exact comoving span of the channel
        z_lo = constants.nu21 / (freqs + freq_width / 2.0) - 1.0
        z_hi = constants.nu21 / (freqs - freq_width / 2.0) - 1.0
        Wi = np.abs(
            np.asarray(model.cosmology.comoving_distance(z_hi), np.float64)
            - np.asarray(model.cosmology.comoving_distance(z_lo), np.float64)
        )
        # windows far below the rpar grid resolution are numerically
        # indistinguishable from no window (and the 4-point combination
        # would cancel catastrophically) — fall back
        if np.max(Wi) < 1e-3 * np.pi / model._kparmax:
            window = "none"

    W = 0.0
    if window == "centre":
        # channel width in comoving distance at band centre
        zc = np.median(z)
        dz = 1e-3
        dchi_dz = (
            model.cosmology.comoving_distance(zc + dz)
            - model.cosmology.comoving_distance(zc - dz)
        ) / (2 * dz)
        dz_dnu = constants.nu21 / np.median(freqs) ** 2
        W = abs(dchi_dz * dz_dnu * freq_width)
    return z, chi, Wi, window, W


def _channel_vectors(model, z, chi):
    """Per-channel growth/bias/prefactor vectors + the grid descriptor."""
    D = model.growth_factor(z) / model.growth_factor(model.ps_redshift)
    return dict(
        chi=np.asarray(chi, np.float64),
        D=np.asarray(D, np.float64),
        f=np.asarray(model.growth_rate(z), np.float64),
        b=np.asarray(model.bias_z(z), np.float64),
        pf=np.asarray(model.prefactor(z), np.float64),
        grid=np.array(
            [model._kperpmin, model._kperpmax, model._nkperp, model._kparmax],
            dtype=np.float64,
        ),
    )


def build_cl_tables_device(model, freqs, freq_width=None, window="exact",
                           n_knots=8192):
    """Device-side table build — the whole DCT pipeline as one jitted program.

    The host builder (:func:`build_cl_tables`) spends minutes evaluating
    P(k) over the (nkperp × nkpar) grid and running f64 DCTs, plus the
    host C_l grid + eigh.  Here host work is reduced to sampling log P(k) on a
    dense uniform log-k grid (``n_knots`` points, milliseconds) and the
    per-channel vectors; the P grid (natural-spline eval in log-log
    space), the three DCT-I transforms (rfft of the even extension) and
    the K̃ double antiderivative all run on the accelerator in float64.

    Replaces the reference's host-only cache build (corr.py:916-942).

    Returns the same dict as :func:`build_cl_tables` with float64 jnp
    arrays.  Must run under ``jax.enable_x64`` (as :func:`device_roots`
    does); feed to :func:`cl_grid` / :func:`cl_roots_device` in the same
    scope.

    Raises
    ------
    ValueError
        For models the device path cannot represent (``ps_2d`` or
        non-positive P(k)) — callers fall back to the host builder; or
        when called without ``jax.enable_x64``.
    """
    if not jax.config.jax_enable_x64:
        raise ValueError("build_cl_tables_device needs jax.enable_x64")
    dtype = jnp.float64
    if getattr(model, "ps_2d", False):
        raise ValueError("device table build supports 1-D P(k) only")
    z, chi, Wi, window, W = _channel_state(model, freqs, freq_width, window)

    # log P(k) knots over exactly the k range the grid can request
    k_lo = float(model._kperpmin)
    k_hi = float(np.hypot(model._kperpmax, model._kparmax))
    lk = np.linspace(np.log(k_lo), np.log(k_hi), n_knots)
    p = np.asarray(model.ps_vv(np.exp(lk)), np.float64)
    if not np.all(np.isfinite(p)) or np.any(p <= 0.0):
        raise ValueError("device table build requires positive finite P(k)")
    lp = np.log(p)
    from ..util.interpolation import natural_spline_coefficients

    y2 = natural_spline_coefficients(lk, lp)

    tabs = _build_tables_device_jit(
        jnp.asarray(lp, dtype), jnp.asarray(np.diff(lp), dtype),
        jnp.asarray(y2, dtype),
        float(lk[0]), float(lk[1] - lk[0]),
        int(model._nkperp), int(model._nkpar),
        float(model._kperpmin), float(model._kperpmax),
        float(model._kparmax), window, float(W),
    )
    out = dict(tabs)
    if window == "exact":
        out["a"] = jnp.asarray(Wi / 2.0, dtype)
    for key, v in _channel_vectors(model, z, chi).items():
        out[key] = jnp.asarray(v, dtype)
    return out


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8, 9, 10, 11))
def _build_tables_device_jit(lp, dlp, y2, lk0, dlk, nkperp, nkpar,
                             kperpmin, kperpmax, kparmax, window, W):
    dt = lp.dtype

    def c(v):
        return jnp.asarray(v, dt)

    kperp = jnp.logspace(
        np.log10(kperpmin), np.log10(kperpmax), nkperp, dtype=dt
    )
    kpar = jnp.linspace(0.0, kparmax, nkpar, dtype=dt)
    k2 = kpar[None, :] ** 2 + kperp[:, None] ** 2

    # natural cubic spline of log P vs log k on the uniform knot grid, in
    # difference form (knot value plus b·Δ); clamping b to [0, 1] pins
    # out-of-range k (cannot occur by construction of the knot range) to
    # the end values
    u = (0.5 * jnp.log(k2) - c(lk0)) / c(dlk)
    n = lp.shape[0]
    i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, n - 2)
    b = jnp.clip(u - i, 0.0, 1.0)
    a = 1.0 - b
    h2_6 = c(dlk * dlk / 6.0)
    logP = lp[i] + (
        b * dlp[i] + ((a**3 - a) * y2[i] + (b**3 - b) * y2[i + 1]) * h2_6
    )
    d = jnp.exp(logP)
    if window == "centre":
        d = d * jnp.sinc(kpar[None, :] * c(W / (2.0 * np.pi))) ** 2
    mu2 = kpar[None, :] ** 2 / k2

    norm = c(kparmax / (2.0 * nkpar))

    def dct1(x):
        # DCT-I as the real part of the rfft of the even extension
        ext = jnp.concatenate([x, x[:, -2:0:-1]], axis=-1)  # length 2N-2
        return jnp.fft.rfft(ext).real * norm

    out = dict(dd=dct1(d), dv=dct1(d * mu2), vv=dct1(d * mu2 * mu2))

    if window == "exact":
        # K̃ double antiderivative + β rows (see _double_antiderivative)
        dr = c(np.pi / kparmax)

        def rc(x):
            inc = (0.5 * dr) * (x[:, 1:] + x[:, :-1])
            c = jnp.cumsum(inc[:, ::-1], axis=-1)[:, ::-1]
            return jnp.pad(c, ((0, 0), (0, 1)))

        for nm in ("dd", "dv", "vv"):
            out[nm] = rc(rc(out[nm]))
        # β = ∫_0^rmax I dr: the trapezoid sum of a DCT-I series collapses
        # exactly to its endpoint terms — Σ″_j cos(πij/(N−1)) = 0 for every
        # i ≥ 1 and Σ″_j (−1)^j = 0, leaving dr·norm·(N−1)·d[:, 0].  This
        # replaces the f32 reverse-cumsum estimate (whose rounding noise
        # dominated the affine restoration) with the host-exact value; for
        # dv/vv the kpar = 0 column carries μ² = 0, so β is exactly zero.
        out["beta_dd"] = c(np.pi / kparmax) * norm * (nkpar - 1) * d[:, 0]
        zero = jnp.zeros((nkperp,), dt)
        out["beta_dv"] = zero
        out["beta_vv"] = zero
    return out


def cl_grid_combined(tables, lmax, l_chunk=512):
    """Device C_l grid with the y-combined factorization of cl_grid_np.

    The rpar (y) table index depends only on the channel pair, never on
    ℓ, so the three spectra are y-lerped and Kaiser-combined into ONE
    [nz², nkperp] matrix N first (row gathers from a y-major stacked
    table — contiguous 3·nkperp rows, no ℓ dimension), leaving the
    ℓ-dependent part as a single row-lerp of N.  Compared to
    :func:`cl_grid_chunked` (12 independent output-sized 2-D gathers per
    ℓ-block) this removes ℓ from every table gather.  Same values as
    cl_grid_np to f32 rounding.

    The x-stage runs as host-looped dispatches of one compiled ℓ-block
    program; blocking bounds the [L, nz²] gather temporaries.
    """
    L = int(lmax) + 1
    la = np.arange(L, dtype=np.float64)
    la[0] = 1e-10
    log10_la = np.log10(la)

    N = _cl_grid_combined_N_jit(tables)
    nz = int(tables["chi"].shape[0])
    blocks = [
        _cl_grid_xlerp_jit(
            tables, N, jnp.asarray(log10_la[lo:lo + l_chunk], N.dtype)
        )
        for lo in range(0, L, l_chunk)
    ]
    return jnp.concatenate(blocks, axis=0).reshape(L, nz, nz)


@jax.jit
def _cl_grid_combined_N_jit(tables):
    """y-combined matrix N [nz², nkperp]: everything ℓ-independent."""
    dd, dv, vv = tables["dd"], tables["dv"], tables["vv"]
    nx, ny = dd.shape
    kparmax = tables["grid"][3]
    chi = tables["chi"]

    xc = 0.5 * (chi[:, None] + chi[None, :])
    rpar = jnp.abs(chi[:, None] - chi[None, :])

    D, f, b, pf = tables["D"], tables["f"], tables["b"], tables["pf"]
    A = (D * pf)[:, None] * (D * pf)[None, :]
    pre = A / (xc**2 * jnp.pi)
    bb = (pre * (b[:, None] * b[None, :])).ravel()
    fb = (pre * (f[:, None] * b[None, :] + f[None, :] * b[:, None])).ravel()
    ff = (pre * (f[:, None] * f[None, :])).ravel()

    # y-major stacked spectra: one row gather fetches all three x-rows
    stackT = jnp.stack([dd.T, dv.T, vv.T], axis=1).reshape(ny, 3 * nx)

    def ylerp_combined(yflat, coefs):
        yy = jnp.clip(yflat, 0.0, ny - 1e-5)
        y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, ny - 2)
        fy = (yy - y0)[:, None]
        R = stackT[y0] * (1.0 - fy) + stackT[y0 + 1] * fy  # [P, 3*nx]
        return jnp.einsum("tp,ptk->pk", coefs, R.reshape(-1, 3, nx),
                          precision=jax.lax.Precision.HIGHEST)

    if "a" in tables:
        av = tables["a"]
        dr = jnp.pi / kparmax
        norm = (1.0 / (4.0 * av[:, None] * av[None, :])).ravel()
        coefs = jnp.stack([bb * norm, fb * norm, ff * norm])
        apb = (av[:, None] + av[None, :]).ravel()
        amb = jnp.abs(av[:, None] - av[None, :]).ravel()
        rp = rpar.ravel()
        N = (
            ylerp_combined((rp + apb) / dr, coefs)
            + ylerp_combined(jnp.abs(rp - apb) / dr, coefs)
            - ylerp_combined((rp + amb) / dr, coefs)
            - ylerp_combined(jnp.abs(rp - amb) / dr, coefs)
        )
        aff = 2.0 * (jnp.maximum(rp, apb) - jnp.maximum(rp, amb))
        beta = jnp.stack(
            [tables["beta_dd"], tables["beta_dv"], tables["beta_vv"]]
        )
        N = N + aff[:, None] * jnp.einsum(
            "tp,tk->pk", coefs, beta, precision=jax.lax.Precision.HIGHEST
        )
    else:
        coefs = jnp.stack([bb, fb, ff])
        N = ylerp_combined((rpar / (jnp.pi / kparmax)).ravel(), coefs)
    return N


@jax.jit
def _cl_grid_xlerp_jit(tables, N, log10_la):
    """Row-lerp of N at x(ℓ, pair) for one ℓ-block → [nl, nz²]."""
    nx = N.shape[1]
    kperpmin, kperpmax, nkperp = (
        tables["grid"][0], tables["grid"][1], tables["grid"][2]
    )
    chi = tables["chi"]
    xc = 0.5 * (chi[:, None] + chi[None, :])
    lxk = jnp.log10(xc.ravel() * kperpmin)
    xsc = (nkperp - 1.0) / jnp.log10(kperpmax / kperpmin)
    x = (log10_la[None, :] - lxk[:, None]) * xsc  # [P, nl]
    x = jnp.clip(x, 0.0, nx - 1e-5)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nx - 2)
    fx = x - x0
    g0 = jnp.take_along_axis(N, x0, axis=1)
    g1 = jnp.take_along_axis(N, x0 + 1, axis=1)
    return (g0 * (1.0 - fx) + g1 * fx).T


def cl_roots_device(tables, lmax, threshold=1e-7):
    """Per-ell channel-covariance roots [lmax+1, nz, nz], built on device.

    ``cl_grid`` → per-ell diagonal normalisation → batched eigh root
    (matrix_root_manynull semantics, util/linalg.py).  The threshold
    default is 1e-7: eigenvalues below ~1e-7·max are below the float32
    resolution of the roots, and only R Rᵀ = C matters downstream (any
    orthogonal mixing of root columns draws the same Gaussian ensemble).
    ‖R Rᵀ − C‖/‖C‖ < 1e-5 (tests/test_skysim.py test_device_cl_setup;
    chip_smoke.py phase a at the flagship size).

    Replaces the reference's host per-ell loop (skysim.py:114-121 +
    nputil.py:51) for the setup path.
    """
    cla = cl_grid_combined(tables, int(lmax))
    return _roots_from_cla_jit(cla, float(threshold))


def device_roots(model, freqs, lmax, window="exact"):
    """Per-ell covariance roots [lmax+1, nz, nz] float32, set up on device
    in float64.

    Float32 setup misses the 1e-5 covariance contract at hundreds of
    channels (the double-antiderivative window combination cancels, and
    f32 DCT tables carry ~5e-6 of rounding).  The tables, the C_l grid
    and the eigh therefore run in float64 under a scoped
    ``jax.enable_x64``; only the roots are cast to float32.
    """
    with jax.enable_x64(True):
        tables = build_cl_tables_device(model, freqs, window=window)
        return cl_roots_device(tables, lmax).astype(jnp.float32)


@partial(jax.jit, static_argnums=(1,))
def _roots_from_cla_jit(cla, threshold):
    from ..util import linalg

    nz = cla.shape[-1]
    dmax = jnp.max(jnp.abs(jnp.diagonal(cla, axis1=1, axis2=2)), axis=1)
    dmax = jnp.where(dmax > 0.0, dmax, 1.0)
    cla_n = cla / dmax[:, None, None] + jnp.eye(nz, dtype=cla.dtype) * 1e-12
    roots = linalg.batch_matrix_root(cla_n, threshold=threshold)
    return roots * jnp.sqrt(dmax)[:, None, None]


def _interp2d(arr, x, y):
    """Bilinear gather-lerp (device)."""
    nx, ny = arr.shape
    xx = jnp.clip(x, 0.0, nx - 1e-5)
    yy = jnp.clip(y, 0.0, ny - 1e-5)
    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, nx - 2)
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, ny - 2)
    fx = xx - x0
    fy = yy - y0
    v00 = arr[x0, y0]
    v01 = arr[x0, y0 + 1]
    v10 = arr[x0 + 1, y0]
    v11 = arr[x0 + 1, y0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * (1 - fx) * fy
        + v10 * fx * (1 - fy)
        + v11 * fx * fy
    )


def cl_grid_np(tables, lmax):
    """Host numpy evaluation of the channel-integrated C_l grid.

    Same math as :func:`cl_grid`; use when the accelerator backend should
    not be touched during setup (e.g. the benchmark's one-time table
    build).

    Evaluation order exploits that the rpar (y) index depends only on the
    channel pair, not on l: the three tables are y-lerped and combined
    with their Kaiser coefficients into ONE (nkperp, nz²) matrix per
    window offset, so the l-dependent part is a single row-lerp gather —
    ~5x fewer output-sized gathers than interpolating each table
    separately (the lmax=1535 × 256² flagship grid is ~100M points).
    """
    g = np.asarray(tables["grid"], dtype=np.float64)
    kperpmin, kperpmax, nkperp, kparmax = g[0], g[1], g[2], g[3]
    chi = np.asarray(tables["chi"], dtype=np.float64)
    la = np.arange(lmax + 1, dtype=np.float64)
    la[la == 0.0] = 1e-10

    xc = 0.5 * (chi[:, None] + chi[None, :])
    rpar = np.abs(chi[:, None] - chi[None, :])
    y2d = rpar / (np.pi / kparmax)

    D = np.asarray(tables["D"], dtype=np.float64)
    f = np.asarray(tables["f"], dtype=np.float64)
    b = np.asarray(tables["b"], dtype=np.float64)
    pf = np.asarray(tables["pf"], dtype=np.float64)

    A = (D * pf)[:, None] * (D * pf)[None, :]
    bb = b[:, None] * b[None, :]
    fb = f[:, None] * b[None, :] + f[None, :] * b[:, None]
    ff = f[:, None] * f[None, :]

    dd = np.asarray(tables["dd"])
    dv = np.asarray(tables["dv"])
    vv = np.asarray(tables["vv"])

    nz = chi.shape[0]
    P = nz * nz
    nx, ny = dd.shape
    pre = A / (xc**2 * np.pi)

    def _ylerp_combined(yflat, coefs, out_buf):
        """N[i, p] = sum_tab coefs[tab][p] * y-lerp of tab at yflat[p]."""
        yy = np.clip(yflat, 0.0, ny - 1e-5)
        y0 = np.clip(np.floor(yy).astype(np.int64), 0, ny - 2)
        fy = yy - y0
        gy = 1.0 - fy
        for r0 in range(0, nx, 64):
            r1 = min(nx, r0 + 64)
            acc = coefs[0] * (dd[r0:r1, y0] * gy + dd[r0:r1, y0 + 1] * fy)
            acc += coefs[1] * (dv[r0:r1, y0] * gy + dv[r0:r1, y0 + 1] * fy)
            acc += coefs[2] * (vv[r0:r1, y0] * gy + vv[r0:r1, y0 + 1] * fy)
            out_buf[r0:r1] = acc
        return out_buf

    lxk = np.log10(xc.ravel() * kperpmin)
    xsc = (nkperp - 1) / np.log10(kperpmax / kperpmin)
    lchunk = max(1, min(256, (1 << 24) // max(P, 1)))
    pidx = np.arange(P)[None, :]

    def _xlerp_into(N, out2d, scale):
        """out2d[l, p] += scale * row-lerp of N at x(l, p), chunked over l."""
        for lo in range(0, lmax + 1, lchunk):
            hi = min(lmax + 1, lo + lchunk)
            x = (np.log10(la[lo:hi])[:, None] - lxk[None, :]) * xsc
            np.clip(x, 0.0, nx - 1e-5, out=x)
            x0 = np.clip(np.floor(x).astype(np.int64), 0, nx - 2)
            fx = x - x0
            out2d[lo:hi] += scale * (
                N[x0, pidx] * (1.0 - fx) + N[x0 + 1, pidx] * fx
            )

    out = np.zeros((lmax + 1, P))
    N = np.empty((nx, P))

    if "a" in tables:
        # exact per-channel windows: 4-point K̃ combination plus the
        # closed-form affine restoration (module doc / _double_antiderivative)
        av = np.asarray(tables["a"], dtype=np.float64)
        dr = np.pi / kparmax
        apb = (av[:, None] + av[None, :]).ravel()
        amb = np.abs(av[:, None] - av[None, :]).ravel()
        rp = rpar.ravel()
        ys = [
            (rp + apb) / dr,
            np.abs(rp - apb) / dr,
            (rp + amb) / dr,
            np.abs(rp - amb) / dr,
        ]
        sgn = (1.0, 1.0, -1.0, -1.0)
        norm = 1.0 / (4.0 * av[:, None] * av[None, :])
        aff = (2.0 * (np.maximum(rp, apb) - np.maximum(rp, amb)))
        coefs = [(pre * bb * norm).ravel(), (pre * fb * norm).ravel(),
                 (pre * ff * norm).ravel()]
        # window-offset lookups into the tab-combined y-lerped matrices
        for s, yj in zip(sgn, ys):
            _xlerp_into(_ylerp_combined(yj, coefs, N), out, s)
        # affine restoration: beta is a function of the kperp row only
        bc = (
            coefs[0][None, :] * np.asarray(tables["beta_dd"], np.float64)[:, None]
            + coefs[1][None, :] * np.asarray(tables["beta_dv"], np.float64)[:, None]
            + coefs[2][None, :] * np.asarray(tables["beta_vv"], np.float64)[:, None]
        )
        N[:] = bc * aff[None, :]
        _xlerp_into(N, out, 1.0)
    else:
        coefs = [(pre * bb).ravel(), (pre * fb).ravel(), (pre * ff).ravel()]
        _xlerp_into(_ylerp_combined(y2d.ravel(), coefs, N), out, 1.0)

    return out.reshape((lmax + 1, nz, nz))


def cl_grid(tables, lmax):
    """Evaluate the full channel-integrated C_l grid on device.

    Returns cla [lmax+1, nz, nz] in the table dtype; fully jitted.
    """
    chi = tables["chi"]
    la = jnp.arange(lmax + 1, dtype=chi.dtype)
    return _cl_grid_rows(tables, la)


def cl_grid_chunked(tables, lmax, l_chunk=128):
    """cl_grid evaluated in ℓ-blocks to bound device-memory temporaries.

    The fused grid holds O(dozens) of [L, nz, nz] gather temporaries —
    21 GB at the flagship size; blocking over ℓ caps the live set at
    ~l_chunk/L of that.  Blocks run as separate dispatches of ONE
    compiled block program, concatenated on device.  Same values as
    cl_grid.
    """
    L = lmax + 1
    nblk = -(-L // l_chunk)
    chi = tables["chi"]
    blocks = [
        _cl_grid_rows_jit(
            tables,
            jnp.arange(ib * l_chunk, (ib + 1) * l_chunk, dtype=chi.dtype),
        )
        for ib in range(nblk)
    ]
    return jnp.concatenate(blocks, axis=0)[:L]


@jax.jit
def _cl_grid_rows_jit(tables, la):
    return _cl_grid_rows(tables, la)


def _cl_grid_rows(tables, la):
    """C_l rows for an arbitrary multipole vector ``la`` [nl] (device)."""
    kperpmin, kperpmax, nkperp, kparmax = (
        tables["grid"][0],
        tables["grid"][1],
        tables["grid"][2],
        tables["grid"][3],
    )
    chi = tables["chi"]
    nz = chi.shape[0]

    la = jnp.where(la == 0.0, 1e-10, la)

    xc = 0.5 * (chi[:, None] + chi[None, :])  # [nz, nz]
    rpar = jnp.abs(chi[:, None] - chi[None, :])

    x = (
        (jnp.log10(la)[:, None, None] - jnp.log10(xc * kperpmin)[None, :, :])
        / jnp.log10(kperpmax / kperpmin)
        * (nkperp - 1)
    )

    if "a" in tables:
        # exact per-channel windows: 4-point K̃ combination plus the
        # closed-form affine restoration (module doc / _double_antiderivative)
        av = tables["a"]
        dr = jnp.pi / kparmax
        apb = av[:, None] + av[None, :]
        amb = jnp.abs(av[:, None] - av[None, :])
        ys = [
            (rpar + apb) / dr,
            jnp.abs(rpar - apb) / dr,
            (rpar + amb) / dr,
            jnp.abs(rpar - amb) / dr,
        ]
        sgn = (1.0, 1.0, -1.0, -1.0)
        norm = (1.0 / (4.0 * av[:, None] * av[None, :]))[None]
        aff = (2.0 * (jnp.maximum(rpar, apb) - jnp.maximum(rpar, amb)))[None]

        def lookup(tab, beta):
            acc = 0.0
            for s, y2 in zip(sgn, ys):
                acc = acc + s * _interp2d(
                    tab, x, jnp.broadcast_to(y2[None], x.shape)
                )
            nb = beta.shape[0]
            xx = jnp.clip(x, 0.0, nb - 1e-5)
            x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, nb - 2)
            bx = beta[x0] * (1 - (xx - x0)) + beta[x0 + 1] * (xx - x0)
            return (acc + bx * aff) * norm

        psdd = lookup(tables["dd"], tables["beta_dd"])
        psdv = lookup(tables["dv"], tables["beta_dv"])
        psvv = lookup(tables["vv"], tables["beta_vv"])
    else:
        y = jnp.broadcast_to((rpar / (jnp.pi / kparmax))[None, :, :], x.shape)

        psdd = _interp2d(tables["dd"], x, y)
        psdv = _interp2d(tables["dv"], x, y)
        psvv = _interp2d(tables["vv"], x, y)

    D, f, b, pf = tables["D"], tables["f"], tables["b"], tables["pf"]
    A = (D * pf)[:, None] * (D * pf)[None, :]
    bb = b[:, None] * b[None, :]
    fb = f[:, None] * b[None, :] + f[None, :] * b[:, None]
    ff = f[:, None] * f[None, :]

    return (A / (xc**2 * jnp.pi))[None] * (
        bb[None] * psdd + fb[None] * psdv + ff[None] * psvv
    )
