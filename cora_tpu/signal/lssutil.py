"""Mathematical utilities for the LSS pipeline.

Re-design of the reference ``cora/signal/lssutil.py``: interpolation and
finite-difference helpers, spherical differential operators, power-spectrum
and correlation-function estimators from map shells, the
Fingers-of-God smoothing kernel, and the lognormal transform.

Differential operators on the sphere are built on the native SHT: the
angular gradient is a spin-1 synthesis (∂θ + i ∂φ/sinθ acting on a scalar
is a spin-1 field), replacing healpy.alm2map_der1 (reference
lssutil.py:225-261).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..util import interpolation as cs
from ..util import xfer
from ..healpix import pixel as hpx
from ..healpix import sht as _sht
from ..healpix import transforms as hputil


def invert_no_zero(x):
    """Reciprocal that maps zeros to zero (caput.algorithms equivalent)."""
    x = np.asarray(x)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(x == 0, 0.0, 1.0 / x)
    return inv


def linspace(x) -> np.ndarray:
    """Config parser producing a linearly spaced array.

    Accepts a dict {start, stop, num[, endpoint]}, a list [start, stop,
    num[, endpoint]] or a ready-made array.
    """
    if not isinstance(x, (dict, list, np.ndarray)):
        raise ValueError(f"Require a dict, list or array type. Got a {type(x)}.")

    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, dict):
        start, stop, num = x["start"], x["stop"], x["num"]
        endpoint = x.get("endpoint", True)
    else:
        start, stop, num = x[0], x[1], x[2]
        endpoint = x[3] if len(x) == 4 else True
    return np.linspace(start, stop, num, endpoint=endpoint)


def sinh_interpolate(x, f, x_t: float = 1, f_t: float = 1) -> Callable:
    """1-D interpolation in arcsinh-scaled space (log-like, zero-safe)."""
    asf = np.arcsinh(np.asarray(f) / f_t)
    asx = np.arcsinh(np.asarray(x) / x_t)
    fs = cs.CubicSpline(asx, asf)

    def _f_asinh(x_):
        sx = np.arcsinh(np.asarray(x_) / x_t)
        return f_t * np.sinh(np.asarray(fs(sx)))

    return _f_asinh


def _fd2_stencil(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """4-point second-derivative stencil on a non-uniform grid.

    Rather than hand-deriving interior and one-sided boundary formulas
    (the reference's approach, cora/signal/lssutil.py:99-186), the
    weights at every target point are the unique solution of the local
    moment conditions  Σ_j w_j (x_j − x_i)^p = 2·δ_{p,2}  for p = 0..3
    (Fornberg's construction), solved as ONE batched 4×4 linear system.
    Each point i uses the window [i−2, i+1] clipped into range, which
    reproduces the classical interior/one-sided stencils exactly.

    Returns ``(idx [n, 4], w [n, 4])`` with
    ``d²f/dx² |_{x_i} ≈ Σ_j w[i, j] f[idx[i, j]]``.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4:
        raise ValueError("diff2 needs at least 4 samples")
    start = np.clip(np.arange(n) - 2, 0, n - 4)
    idx = start[:, None] + np.arange(4)[None, :]
    dx = x[idx] - x[:, None]                                # [n, 4]
    V = dx[:, None, :] ** np.arange(4)[None, :, None]       # [n, p, j]
    rhs = np.zeros((n, 4, 1))
    rhs[:, 2, 0] = 2.0
    return idx, np.linalg.solve(V, rhs)[..., 0]


def diff2(f: np.ndarray, x: np.ndarray, axis: int = -1) -> np.ndarray:
    """Second derivative on a non-uniform grid.

    4-point stencil whose weights come from :func:`_fd2_stencil` (one
    batched Vandermonde solve — interior and boundary points are the
    same code path); applied as a gather + weighted sum over the
    derivative axis.
    """
    f = np.asarray(f)
    axis = axis % f.ndim
    idx, w = _fd2_stencil(np.asarray(x))
    fm = np.moveaxis(f, axis, 0)
    out = np.einsum("ij,ij...->i...", w, fm[idx])
    return np.moveaxis(out, 0, axis).astype(f.dtype, copy=False)


def diff2_matrix(x: np.ndarray) -> np.ndarray:
    """The :func:`diff2` stencil as a dense [n, n] matrix.

    ``diff2_matrix(x) @ f == diff2(f, x, axis=0)`` (same weights; only
    the summation order differs).  Radial operators expressed as
    matrices apply as one pixel-sharded matmul on a device mesh — the
    device form of the reference's pixel-redistributed radial
    derivative loops (cora/signal/lss.py:886).
    """
    idx, w = _fd2_stencil(x)
    n = len(idx)
    D = np.zeros((n, n))
    np.put_along_axis(D, idx, w, axis=1)
    return D


def gradient_matrix(x: np.ndarray) -> np.ndarray:
    """``np.gradient(f, x, axis=0)`` as a dense [n, n] matrix.

    Second-order interior stencil on the non-uniform grid, first-order
    one-sided edges (numpy's edge_order=1 default) — the radial part of
    :func:`gradient` as one pixel-sharded matmul.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    G = np.zeros((n, n))

    i = np.arange(1, n - 1)
    hd = x[i] - x[i - 1]
    hs = x[i + 1] - x[i]
    G[i, i - 1] = -hs / (hd * (hd + hs))
    G[i, i] = (hs - hd) / (hs * hd)
    G[i, i + 1] = hd / (hs * (hd + hs))

    G[0, 0] = -1.0 / (x[1] - x[0])
    G[0, 1] = 1.0 / (x[1] - x[0])
    G[-1, -2] = -1.0 / (x[-1] - x[-2])
    G[-1, -1] = 1.0 / (x[-1] - x[-2])
    return G


def laplacian(maps: np.ndarray, x: np.ndarray,
              lmax: Optional[int] = None) -> np.ndarray:
    """Laplacian of a stack of HEALPix shells at radii x.

    Angular part via −l(l+1) in harmonic space, radial part by finite
    differences (reference lssutil.py:188-224).

    The analysis band defaults to ℓ ≤ 2·nside, NOT healpy's 3·nside−1:
    HEALPix pixel quadrature is exact-class only to ~2·nside, and the
    −l(l+1) weighting amplifies the corner-band residual into
    order-unity polar-cap artefacts (measured in tests/test_lssutil.py).
    The LSS fields this operates on are steeply red, so the truncation
    itself is negligible; pass lmax=3*nside-1 for reference-shaped
    behaviour on arbitrary inputs.
    """
    maps = np.asarray(maps)
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 2 * nside

    alms = xfer.get(_sht.map2alm(maps, lmax, 3))
    ell = np.arange(lmax + 1)[:, None]
    alms *= -ell * (ell + 1)

    # np.array (copy): jax device buffers view as read-only ndarrays
    d2 = np.array(_sht.alm2map(jnp.asarray(alms), nside))
    d2 /= x[:, np.newaxis] ** 2

    d2 += diff2(maps, x, axis=0) + 2 * np.gradient(maps, x, axis=0) / x[:, np.newaxis]
    return d2


def gradient(maps: np.ndarray, x: np.ndarray, grad0: bool = True,
             lmax: Optional[int] = None) -> np.ndarray:
    """Gradient of a stack of HEALPix shells: [d/dr, dθ/r, dφ/(r sinθ)].

    The angular derivatives are one batched spin-1 synthesis: for a scalar
    field f, (∂θ f) + i (∂φ f / sinθ) = −Σ sqrt(l(l+1)) a_lm ₁Y_lm.

    Analysis band defaults to ℓ ≤ 2·nside (see :func:`laplacian` — the
    √(l(l+1)) weighting amplifies the above-2·nside quadrature residual
    ~100× at the poles); pass lmax explicitly to override.
    """
    from ..healpix import spin as _spin

    maps = np.asarray(maps)
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 2 * nside
    nmaps = maps.shape[0]

    grad = np.zeros((3,) + maps.shape, dtype=maps.dtype)

    alm = xfer.get(_sht.map2alm(maps, lmax, 3))
    ell = np.arange(lmax + 1)[:, None]
    almE = alm * np.sqrt(ell * (ell + 1.0))

    op = _spin.get_spin_sht(nside, lmax, 1)
    aE = xfer.put(-almE)
    dth, dph = op.synthesis(aE, jnp.zeros_like(aE))
    grad[1] = np.asarray(dth) / x[:, np.newaxis]
    grad[2] = np.asarray(dph) / x[:, np.newaxis]

    if grad0:
        grad[0] = np.gradient(maps, x, axis=0)

    return grad


def cutoff(x, cut: float, sign: int, width: float, index: float):
    """Smooth tanh cutoff: ~1 on one side, power-law dropoff on the other."""
    sign = np.sign(sign)
    return (0.5 * (1 + np.tanh(sign * (np.log10(x) - cut) / width))) ** index


def _m_weights(lmax: int) -> np.ndarray:
    """Σ over m = −l..l expressed on the m ≥ 0 half: weight 1 at m = 0,
    2 at m > 0 (real fields / Hermitian products)."""
    w = np.full(lmax + 1, 2.0)
    w[0] = 1.0
    return w


def pk_flat(
    maps: np.ndarray,
    chi: np.ndarray,
    maps2: Optional[np.ndarray] = None,
    lmax: Optional[int] = None,
    window: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Estimate a 2D (k_par, k_perp) power spectrum from spherical shells.

    Flat-sky thin-shell estimator (semantics of reference
    lssutil.py:293-376), re-designed as one batched device program: the
    radial DFT modes of the shell stack are complex maps f_n = u_n + i·v_n;
    instead of one complex SHT per mode (the reference's per-shell healpy
    loop) ALL real/imaginary parts go through a single batched
    :func:`~cora_tpu.healpix.sht.map2alm`, and the full-m power sum
    Σ_{m=−l..l} |a_lm|² collapses onto the m ≥ 0 half exactly:

        Σ_m |a^{f}_lm|² = Σ_{m≥0} w_m (|a^{u}_lm|² + |a^{v}_lm|²),

    with w_0 = 1, w_{m>0} = 2 (and Re Σ_m a b* likewise for the cross
    spectrum) — no full-m alm array is ever built.
    """
    if maps2 is not None and maps.shape != maps2.shape:
        raise ValueError("Shape of maps2 is not compatible with maps")

    chi = np.asarray(chi, dtype=np.float64)
    chi_mean = chi.mean()
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 3 * nside

    N = len(chi)
    dx = np.ptp(chi) / (N - 1)
    L = N * dx

    def _halfm_mode_alms(m):
        # radial rfft (host — cheap, f64) then ONE batched analysis of
        # the 2·nk real component maps (hputil's healpy-contract iter)
        cn = np.fft.rfft(np.asarray(m, np.float64), axis=0) / N
        parts = np.concatenate([cn.real, cn.imag], axis=0)
        alm = _sht.map2alm(parts, lmax, hputil._iter)
        nk = cn.shape[0]
        return alm[:nk], alm[nk:]          # a^u, a^v  [nk, l, m≥0]

    wm = jnp.asarray(_m_weights(lmax))
    U, V = _halfm_mode_alms(maps)
    if maps2 is None:
        cln = jnp.sum((jnp.abs(U) ** 2 + jnp.abs(V) ** 2) * wm, axis=-1)
    else:
        P, Q = _halfm_mode_alms(maps2)
        cln = jnp.sum(
            (U * jnp.conj(P) + V * jnp.conj(Q)).real * wm, axis=-1
        )

    ell = np.arange(lmax + 1)
    cln = np.asarray(cln) / (2 * ell + 1) * (L * chi_mean**2)

    kperp = ell / chi_mean
    kpar = 2 * np.pi * np.arange(cln.shape[0]) / L

    if window:
        Wk = np.sinc(kpar * dx / (2 * np.pi))
        cln /= Wk[:, np.newaxis] ** 2

    return cln, kpar, kperp


def corrfunc(
    maps: np.ndarray,
    chi: np.ndarray,
    lmax: Optional[int] = None,
    rmax: float = 1e3,
    numr: int = 1024,
) -> Tuple[np.ndarray, np.ndarray]:
    """Estimate a 1D correlation function ξ(r) from spherical shells.

    Semantics of reference lssutil.py:379-443 (cross-C_l between all
    shell pairs → Legendre resum → separation-binned average), re-built
    as a device pipeline with no per-pair loop:

    1. one batched analysis of the whole shell stack;
    2. the full pair cross-spectrum Gram tensor in one einsum over
       the m-weighted alms, C_l(a,b) = Σ_m w_m Re(a_{alm} a*_{blm});
    3. ξ(a, b, θ) = C @ P̃_l(cos θ) as one matmul against the
       (2l+1)/4π-weighted Legendre matrix;
    4. comoving pair separations from the law of cosines
       r² = χ_a² + χ_b² − 2 χ_a χ_b cos θ, averaged into uniform r bins
       by ``segment_sum`` (deterministic device scatter).

    The sample set (unordered shell pairs × 2048 uniform θ points) and
    the output binning match the reference estimator.
    """
    from .corrfunc import legendre_array

    maps = np.asarray(maps)
    if lmax is None:
        lmax = 3 * hpx.npix2nside(maps.shape[1]) - 1

    chi = np.asarray(chi, dtype=np.float64)
    nx = len(chi)
    alm = _sht.map2alm(maps, lmax, 3)                   # [nx, l, m]

    # pair Gram tensor; m-weights folded in on one operand
    wm = jnp.asarray(_m_weights(lmax))
    gram = jnp.einsum(
        "alm,blm->abl", alm, jnp.conj(alm * wm)
    ).real / (2.0 * jnp.arange(lmax + 1) + 1.0)

    a_i, b_i = np.triu_indices(nx)                      # each pair once
    clxx = gram[a_i, b_i]                               # [npair, l]

    theta = np.linspace(0, np.pi, 2048)
    mu = np.cos(theta)
    Pl_w = legendre_array(lmax, mu) * (
        (2 * np.arange(lmax + 1)[:, np.newaxis] + 1) / (4 * np.pi)
    )
    ctheta = jnp.matmul(clxx, jnp.asarray(Pl_w), precision=jax.lax.Precision.HIGHEST)  # ξ(a, b, θ)

    r1 = jnp.asarray(chi[a_i])[:, None]
    r2 = jnp.asarray(chi[b_i])[:, None]
    mu_d = jnp.asarray(mu)[None, :]
    rc = jnp.sqrt(r1**2 + r2**2 - 2 * r1 * r2 * mu_d)

    # uniform-bin average via deterministic segment-sum; out-of-range
    # separations park in a discard bin
    dr = rmax / numr
    idx = jnp.floor(rc / dr).astype(jnp.int32)
    idx = jnp.where((idx >= 0) & (idx < numr), idx, numr)
    norm = jax.ops.segment_sum(
        jnp.ones_like(rc).ravel(), idx.ravel(), num_segments=numr + 1
    )
    csum = jax.ops.segment_sum(
        ctheta.ravel(), idx.ravel(), num_segments=numr + 1
    )

    norm, csum = np.asarray(norm)[:numr], np.asarray(csum)[:numr]
    rcentre = (np.arange(numr) + 0.5) * dr
    return csum * invert_no_zero(norm), rcentre


def ang_correlation(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Angular correlation coefficient r_l between two maps."""
    cl_xx = np.asarray(_sht.anafast(x))
    cl_yy = np.asarray(_sht.anafast(y))
    cl_xy = np.asarray(_sht.anafast(x, y))
    return cl_xy / (cl_xx * cl_yy) ** 0.5


def transfer(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Angular transfer function T_l = C_l^{xy} / C_l^{yy}."""
    cl_yy = np.asarray(_sht.anafast(y))
    cl_xy = np.asarray(_sht.anafast(x, y))
    return cl_xy / cl_yy


def calculate_width(centres: np.ndarray) -> np.ndarray:
    """Estimate contiguous bin widths from bin centres."""
    centres = np.asarray(centres, dtype=np.float64)
    widths = np.zeros(len(centres))
    widths[1:-1] = (centres[2:] - centres[:-2]) / 2.0
    widths[0] = 2 * (centres[1] - (widths[1] / 2.0) - centres[0])
    widths[-1] = 2 * (centres[-1] - (widths[-2] / 2.0) - centres[-2])
    return np.abs(widths)


def exponential_FoG_kernel(chi: np.ndarray, sigmaP, D) -> np.ndarray:
    r"""Exponential radial smoothing kernel approximating Fingers of God.

    Real-space conjugate of the squared-Lorentzian velocity damping
    :math:`(1 + k_\parallel^2\sigma_P^2/2)^{-1}`, i.e. the normalised
    kernel :math:`e^{-a|\Delta\chi|}` with decay rate
    :math:`a = \sqrt{2}/\sigma_P` per *target* bin.  Matrix elements are
    the kernel integrated over each source bin's top-hat width w:

    * off-diagonal: :math:`\int e^{-a|x|}` over a bin at separation s
      gives :math:`e^{-a s}\,\mathrm{sinhc}(a w / 2)`;
    * diagonal (bin integrates over its own width, split at the peak):
      :math:`e^{-a w/4}\,\mathrm{sinhc}(a w / 4)`.

    Rows are normalised to unit sum (mass conservation), and a growth
    factor already multiplied into each source bin is conjugated out and
    re-applied at the target: :math:`K \to \mathrm{diag}(D) K
    \mathrm{diag}(D)^{-1}`.  Same semantics as reference
    lssutil.py:518-589, independently built from the closed forms above
    (single masked-select assembly, no in-place diagonal fill).
    """
    chi = np.asarray(chi, dtype=np.float64)
    n = len(chi)
    a = np.sqrt(2.0) / np.broadcast_to(np.asarray(sigmaP, np.float64), (n,))
    D = np.broadcast_to(np.asarray(D, np.float64), (n,))

    w = calculate_width(chi)
    aw = a[:, None] * w[None, :]                  # target rate × source width
    sep = np.abs(chi[:, None] - chi[None, :])

    def sinhc(x):
        return np.sinh(x) / x

    off_diag = np.exp(-a[:, None] * sep) * sinhc(aw / 2.0)
    self_bin = np.exp(-aw / 4.0) * sinhc(aw / 4.0)
    K = np.where(np.eye(n, dtype=bool), self_bin, off_diag)

    K /= K.sum(axis=1, keepdims=True)
    return K * (D[:, None] / D[None, :])


def lognormal_transform(
    field: np.ndarray, out: Optional[np.ndarray] = None, axis: int = None
) -> np.ndarray:
    """Lognormal point transform with matched mean: exp(δ − σ²/2) − 1.

    Functional form (reference lssutil.py:592-627 does the same map with
    in-place ufuncs); ``out`` may alias ``field`` or be an HDF5 dataset —
    the result is computed first and assigned once.
    """
    field = np.asarray(field) if out is None else field
    res = np.exp(field - np.var(field, axis=axis, keepdims=True) / 2.0) - 1.0
    if out is None:
        return res
    if np.shape(out) != np.shape(field) or out.dtype != np.asarray(field).dtype:
        raise ValueError("Given output array is incompatible.")
    out[:] = res
    return out


def assert_shape(arr, shape, name):
    """Raise ValueError unless ``arr.shape == shape`` (dims checked first)."""
    got, want = tuple(arr.shape), tuple(shape)
    if len(got) != len(want):
        raise ValueError(
            f"Array {name} has wrong number of dimensions (got {len(got)}, "
            f"expected {len(want)}"
        )
    if got != want:
        raise ValueError(
            f"Array {name} has the wrong shape (got {got}, expected {want}"
        )
