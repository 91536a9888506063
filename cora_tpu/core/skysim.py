"""Correlated full-sky Gaussian realisations — the synthesis hot path.

Re-design of the reference ``cora/core/skysim.py``.  The pipeline is
"quadrature → per-ell linear algebra → SHT" (SURVEY.md §7):

1. ``clarray`` tabulates C_l(z, z') with finite channel-width integration
   (Romberg oversampling, matching skysim.py:10-69 semantics, plus a
   sinc²-window mode that folds the channel integral into the
   kpar direction of the DCT table at zero cost).
2. ``mkfullsky`` draws correlated a_lm: batched per-ell matrix roots
   (eigh-clipped, replacing the per-ell cholesky/eigh fallback loop of
   skysim.py:114-121 + nputil.matrix_root_manynull with one fused XLA
   program), a keyed-RNG complex-normal draw, and the native batched SHT.
   The whole draw+transform is one jitted device program; the reference's
   MPI ell→frequency redistribute (skysim.py:128) becomes a sharding
   constraint under the mesh (see cora_tpu.parallel).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..healpix import sht as _sht
from ..util import linalg


def _romberg_avg_weights(order):
    """Averaging weights of Romberg quadrature on 2**order + 1 uniform
    samples spanning one channel (they sum to 1).

    Romberg integration is a fixed linear functional of the samples —
    Richardson extrapolation of the nested trapezoid sums — so instead of
    running the extrapolation per integrand we extrapolate the trapezoid
    *weight vectors* once and contract.  Dividing by the span turns the
    integral weights into channel-averaging weights.
    """
    n = 1 << order
    col = []
    for k in range(order + 1):
        stride = n >> k
        idx = np.arange(0, n + 1, stride)
        w = np.zeros(n + 1)
        w[idx] = stride  # trapezoid at refinement level k, h = stride·dx
        w[idx[0]] = w[idx[-1]] = stride / 2.0
        col.append(w)
    for m in range(1, order + 1):
        fac = 4.0**m
        col = [
            (fac * col[k] - col[k - 1]) / (fac - 1.0)
            for k in range(1, len(col))
        ]
    return col[0] / n  # integral weights · dx/span, with span = n·dx


def clarray(aps, lmax, zarray, zromb=3, zwidth=None, block_bytes=2**28):
    """Tabulate the channel-averaged C_l(z, z') over a frequency grid.

    Each entry is the double channel average
    ``(1/Δz²) ∫∫ C_l(z, z') dz dz'`` over the channel squares, evaluated
    with Romberg quadrature of the given order — the same quadrature the
    reference applies (skysim.py:10-69), here expressed as an explicit
    weight functional contracted in one einsum per ℓ-block.

    Parameters
    ----------
    aps : callable
        Angular power spectrum aps(l, z1, z2), numpy-broadcasting.
    lmax : int
        Maximum multipole.
    zarray : np.ndarray
        Channel centres (redshift or frequency, whatever `aps` expects).
    zromb : int
        Romberg order: 2**zromb + 1 sub-samples per channel; 0 skips the
        channel integration entirely (point evaluation at the centres).
    zwidth : float, optional
        Channel width; default: spacing of the two smallest entries.
    block_bytes : int
        Target size of one ℓ-block's sample cube; bounds peak memory
        (the reference instead hard-codes ~5 ℓ per block).

    Returns
    -------
    cla : np.ndarray[lmax+1, nz, nz]
    """
    zarray = np.asarray(zarray, dtype=np.float64)
    ells = np.arange(lmax + 1)

    if zromb == 0:
        return aps(
            ells[:, np.newaxis, np.newaxis],
            zarray[np.newaxis, :, np.newaxis],
            zarray[np.newaxis, np.newaxis, :],
        )

    if zwidth is None:
        lo = np.sort(zarray)[:2]
        zwidth = abs(lo[1] - lo[0])
    half = zwidth / 2.0

    nsub = (1 << zromb) + 1
    w = _romberg_avg_weights(zromb)
    zsub = (zarray[:, None] + np.linspace(-half, half, nsub)).ravel()

    nz = zarray.size
    cla = np.empty((lmax + 1, nz, nz), dtype=np.float64)
    lstep = max(1, int(block_bytes // (8 * (nz * nsub) ** 2)))
    for l0 in range(0, lmax + 1, lstep):
        lb = ells[l0 : l0 + lstep]
        c = aps(
            lb[:, np.newaxis, np.newaxis],
            zsub[np.newaxis, :, np.newaxis],
            zsub[np.newaxis, np.newaxis, :],
        ).reshape(lb.size, nz, nsub, nz, nsub)
        cla[l0 : l0 + lstep] = np.einsum(
            "a,b,liajb->lij", w, w, c, optimize=True
        )
    return cla


def host_covariance_roots(corr):
    """Per-ell covariance matrix roots on host in float64.

    Batched eigh with tiny-eigenvalue clipping (the reference's
    matrix_root_manynull semantics, nputil.py:51) — used on accelerators
    whose runtimes lack f64 device eigh.
    """
    corr = np.asarray(corr, dtype=np.float64)
    nz = corr.shape[-1]
    cmax = np.abs(np.diagonal(corr, axis1=-2, axis2=-1)).max(
        axis=-1, keepdims=True
    )
    corrm = (corr + (cmax * 1e-14)[..., None] * np.eye(nz)) / np.where(
        cmax[..., None] > 0, cmax[..., None], 1.0
    )
    evals, evecs = np.linalg.eigh(corrm)
    evals = np.where(
        evals > evals.max(axis=-1, keepdims=True) * 1e-16, evals, 0.0
    )
    return (evecs * np.sqrt(evals)[..., None, :]) * np.sqrt(
        np.where(cmax > 0, cmax, 1.0)
    )[..., None]


@partial(jax.jit, static_argnames=("dtype",))
def draw_alm_from_roots(roots, key, dtype=jnp.complex64):
    """Correlated a_lm draw from precomputed per-ell roots [L, nz, nz]."""
    lmax1, numz, _ = roots.shape
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    gauss = linalg.complex_std_normal(key, (lmax1, numz, lmax1), dtype=rdtype)
    alm = jnp.einsum("lzy,lym->lzm", roots.astype(dtype), gauss,
                     precision=jax.lax.Precision.HIGHEST)
    mmask = (jnp.arange(lmax1)[None, :] <= jnp.arange(lmax1)[:, None])[:, None, :]
    return jnp.moveaxis(alm * mmask, 0, 1)  # [nz, l, m]


def draw_correlated_alm(corr, key, dtype=jnp.complex128):
    """Draw a_lm with per-ell covariance C_l(z, z') (jittable).

    Parameters
    ----------
    corr : jnp.ndarray[lmax+1, nz, nz]
        Per-multipole frequency-frequency covariance.
    key : jax.random.PRNGKey

    Returns
    -------
    alm : jnp.ndarray[nz, lmax+1, lmax+1] complex — dense [l, m] layout.
    """
    lmax1, numz, _ = corr.shape
    rdtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32

    corr = corr.astype(rdtype)
    # jitter for positive definiteness (reference skysim.py:116-117)
    cmax = jnp.max(
        jnp.abs(jnp.diagonal(corr, axis1=-2, axis2=-1)), axis=-1, keepdims=True
    )
    corrm = corr + (cmax * 1e-14)[..., None] * jnp.eye(numz, dtype=rdtype)

    # batched matrix roots over ell — single fused eigh kernel
    trans = linalg.batch_matrix_root(corrm)  # [L, nz, nz]

    gauss = linalg.complex_std_normal(key, (lmax1, numz, lmax1), dtype=rdtype)

    # alm[l, z, m] = sum_z' trans[l, z, z'] xi[l, z', m], masked to m <= l
    alm = jnp.einsum("lzy,lym->lzm", trans.astype(dtype), gauss,
                     precision=jax.lax.Precision.HIGHEST)
    mmask = (jnp.arange(lmax1)[None, :] <= jnp.arange(lmax1)[:, None])[:, None, :]
    alm = alm * mmask
    return jnp.moveaxis(alm, 0, 1)  # [nz, l, m]


def mkfullsky(corr, nside, alms=False, key=None, rng=None, dtype=jnp.complex128):
    """Construct a set of correlated HEALPix maps from C_l(z, z').

    Parameters
    ----------
    corr : np.ndarray[lmax+1, numz, numz]
        The correlation matrix C_l(z, z').
    nside : int
        HEALPix resolution of the output maps.
    alms : bool
        If True return the dense a_lm array instead of maps.
    key : jax.random.PRNGKey, optional
        RNG key (keyed JAX RNG replaces the reference's global numpy RNG;
        statistics match, streams intentionally do not).
    rng : np.random.Generator, optional
        Accepted for API compatibility: if given (and no key), its bits
        seed a JAX key.

    Returns
    -------
    hpmaps : np.ndarray[numz, npix]  (or alm array if alms=True)
    """
    corr = jnp.asarray(np.asarray(corr))
    maxl = corr.shape[0] - 1
    numz = corr.shape[1]
    if corr.shape[2] != numz:
        raise ValueError("Correlation matrix is incorrect shape.")

    if key is None:
        if rng is not None:
            seed = int(rng.integers(0, 2**31 - 1)) if hasattr(rng, "integers") else int(
                rng.randint(0, 2**31 - 1)
            )
        else:
            seed = np.random.randint(0, 2**31 - 1)
        key = jax.random.PRNGKey(seed)

    if not alms and jax.default_backend() != "cpu":
        # accelerator path: the synthesis runs in f32 there, so the
        # covariance is factored on host in f64 and the cube is drawn and
        # synthesised per frequency chunk (the dense [nz, L, L] alm cube
        # never sits in device memory)
        if dtype == jnp.complex128:
            import warnings

            warnings.warn(
                "mkfullsky: complex128 requested on an accelerator; the "
                "covariance roots are built in f64 on host but the draw "
                "and synthesis run in complex64 and the maps are single "
                "precision.",
                stacklevel=2,
            )
        parts = [
            m
            for _, m in mkfullsky_streamed(
                np.asarray(corr), nside, key=key,
                fchunk=min(16, corr.shape[1]),
            )
        ]
        return np.concatenate(parts, axis=0)[: corr.shape[1]]

    if dtype == jnp.complex128 and not jax.config.jax_enable_x64:
        # no f64 on the device without x64: factor the covariance on host
        # in f64 and draw in complex64
        roots = jnp.asarray(host_covariance_roots(np.asarray(corr)),
                            jnp.float32)
        alm = draw_alm_from_roots(roots, key, dtype=jnp.complex64)
    else:
        alm = draw_correlated_alm(corr, key, dtype=dtype)
    if alms:
        return np.asarray(alm)
    return np.asarray(_sht.alm2map(alm, nside))


def mkfullsky_jit(corr, nside, lmax, key, dtype=jnp.complex64):
    """Fully-jitted synthesis: corr (device array) + key -> maps (device).

    This is the flagship single-program path used by the benchmark and the
    multi-chip entry: draw + batched SHT fused into one XLA program.
    """
    op = _sht.get_sht(int(nside), int(lmax))

    @jax.jit
    def _run(corr, key):
        alm = draw_correlated_alm(corr, key, dtype=dtype)
        return op.synthesis(alm)

    return _run(corr, key)


def mkconstrained(corr, constraints, nside, key=None):
    """Construct correlated maps satisfying constraints on given slices.

    Eigen-mode construction matching the reference (skysim.py:139-201):
    keep the largest `nmodes` eigenmodes per ell, solve for amplitudes that
    reproduce the constraint maps at the given frequency indices, and
    project across the full frequency range.

    Parameters
    ----------
    corr : np.ndarray[lmax+1, numz, numz]
    constraints : list of (freq_index, healpix_map)
    nside : int

    Returns
    -------
    hpmaps : np.ndarray[numz, npix]
    """
    corr = np.asarray(corr)
    numz = corr.shape[1]
    maxl = corr.shape[0] - 1
    nmodes = len(constraints)
    f_ind = [c[0] for c in constraints]

    if corr.shape[2] != numz:
        raise ValueError("Correlation matrix is incorrect shape.")

    # Batched eigendecomposition over ell: largest nmodes eigenvectors.
    # Always f64 on host — the mode selection is the numerically
    # sensitive part.
    evals, evecs = np.linalg.eigh(corr)  # [L, nz, nz]
    trans = np.swapaxes(evecs[:, :, -nmodes:], 1, 2)  # [L, nmodes, nz]
    tmat = trans[:, :, f_ind]  # [L, nmodes, nmodes]

    # Constraint maps into harmonic space (batched analysis).  The SHT
    # legs follow the constraint maps' dtype: float32 inputs run the
    # f32 transform pair — the device-safe precision on accelerator
    # placements, and ample for constraining a *random realisation*
    # (the reference's f64 healpy analysis is a precision choice, not a
    # statistical requirement).
    in_dt = np.result_type(*(np.asarray(c[1]).dtype for c in constraints))
    sht_dt = np.float32 if in_dt == np.float32 else np.float64
    cons_maps = np.stack([np.asarray(c[1], dtype=sht_dt) for c in constraints])
    calm = np.asarray(_sht.map2alm(jnp.asarray(cons_maps), maxl, 3))  # [nm, l, m]

    # Solve tmat[l].T x = calm[:, l, m] for every ell at once, project
    # cv = trans.T @ x (l = 0 zeroed as in the reference).
    x = np.linalg.solve(
        np.swapaxes(tmat[1:], 1, 2),
        calm.transpose(1, 0, 2)[1:].astype(np.complex128),
    )  # [L-1, nmodes, m]  (ell=0 excluded: its mode matrix can be singular)
    cv = np.zeros((numz, maxl + 1, maxl + 1), dtype=np.complex128)
    cv[:, 1:, :] = np.einsum("lnz,lnm->zlm", trans[1:], x)
    cv = cv.astype(np.complex64 if sht_dt == np.float32 else np.complex128)

    # zero m > l already guaranteed by calm structure
    return np.asarray(_sht.alm2map(jnp.asarray(cv), nside))


def _synth_corr_jit():
    """Module-cached jit of sht.synthesis_grid_correlated.

    One wrapper for the whole process so repeat mkfullsky calls on the
    same operator hit the trace cache instead of re-tracing (a fresh
    ``jax.jit`` object per call has an empty cache even when the
    underlying compile is XLA-cache-warm)."""
    global _SYNTH_CORR_JIT
    try:
        return _SYNTH_CORR_JIT
    except NameError:
        from ..healpix.sht import synthesis_grid_correlated

        _SYNTH_CORR_JIT = jax.jit(
            synthesis_grid_correlated, static_argnums=(0, 5)
        )
        return _SYNTH_CORR_JIT


def mkfullsky_streamed(corr, nside, key=None, fchunk=16, op=None, roots=None):
    """Generator: correlated sky cube in frequency chunks, host pixel maps.

    For cubes too large for device HBM or host RAM in one piece
    (Nside≥512, hundreds of channels): per-ℓ covariance roots are built
    once on host, each chunk of frequencies is synthesized on device with
    the fused streaming draw (`sht.synthesis_grid_correlated` — the full
    a_lm cube never exists), and yielded as (z_lo, maps[fchunk, npix])
    host arrays via the native ring-grid → pixel converter.

    All chunks share one white-noise realisation (same key), so
    concatenating the yields equals a single `mkfullsky` draw of the whole
    cube statistically.

    Above nside=512 get_sht selects the Λ-free checkpointed-scan
    Legendre mode (the cached Λ table is 38 GB at nside=1024).

    ``roots``: precomputed per-ell covariance roots [lmax+1, nz, nz]
    (e.g. built on device by :func:`cora_tpu.signal.clfast.cl_roots_device`
    — the zero-transfer cold-start path); ``corr`` is ignored when given.
    """
    from .. import native
    from ..healpix import pixel as _pixel
    from ..healpix.sht import get_sht

    if key is None:
        key = jax.random.PRNGKey(np.random.randint(0, 2**31 - 1))

    if roots is not None:
        lmax = roots.shape[0] - 1
        nz = roots.shape[1]
        roots_d = jnp.asarray(roots, jnp.float32)
    else:
        corr = np.asarray(corr)
        lmax = corr.shape[0] - 1
        nz = corr.shape[1]
        # roots on host in float64 (independent of jax_enable_x64)
        roots_d = jnp.asarray(host_covariance_roots(corr), jnp.float32)

    if op is None:
        # the cached, placement-aware factory: one operator (and one set
        # of resident device tables, disk-cached Λ/checkpoint builds) per
        # geometry per process.  Constructing a throwaway SHT here cost
        # every repeat mkfullsky call a full host Λ rebuild + device
        # transfer + jit retrace — measured 8 s/call at nside=128 × 64 ch
        # in the constrained-galaxy steady state.
        op = get_sht(int(nside), int(lmax))
    elif op.nside != int(nside) or op.lmax != int(lmax):
        raise ValueError("op does not match requested nside/lmax")
    tables = op.tables(False)
    info = _pixel.ring_info(int(nside))
    npix = _pixel.nside2npix(int(nside))

    synth = _synth_corr_jit()

    fchunk = min(fchunk, nz)
    for z_lo in range(0, nz, fchunk):
        nc = min(fchunk, nz - z_lo)
        if nc != fchunk:  # ragged tail: synthesize at fchunk, trim
            z_lo = nz - fchunk
            nc = fchunk
        g = np.asarray(synth(op, tables, roots_d, key, z_lo, fchunk))
        maps = native.grid_to_pixels(
            g, info["start"].astype(np.int64), info["nphi"].astype(np.int64),
            npix,
        )
        yield z_lo, maps
