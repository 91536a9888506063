"""Linear-algebra helpers: robust matrix roots and complex normals.

Replaces the reference ``cora/util/nputil.py:51-125``.  The key routine is
``matrix_root_manynull``: a square root for covariance matrices with a huge
dynamic range of eigenvalues, where Cholesky fails due to roundoff.

The device variant ``batch_matrix_root`` avoids data-dependent Python
control flow entirely (SURVEY.md §7 risk #2): it computes a batched ``eigh``,
clips tiny/negative eigenvalues to zero, and forms ``V sqrt(Λ)`` — giving the
same map statistics as the reference's cholesky-with-eigh-fallback while
staying a single fused XLA program over the whole (lmax+1)-batch.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def matrix_root_manynull(mat, threshold=1e-16, truncate=True):
    """Square root a single matrix, host-side (numpy/scipy semantics).

    Tries Cholesky first; on failure does an eigendecomposition and zeroes
    eigenvalues below ``threshold * max(eigenvalue)``.  Mirrors the reference
    nputil.py:51-101 behaviour including the ``truncate`` return convention.
    """
    import scipy.linalg as la

    mat = np.asarray(mat)
    try:
        root = la.cholesky(mat, lower=True)
        num_pos = mat.shape[0]
    except la.LinAlgError:
        evals, evecs = la.eigh(mat)
        evals[evals < evals.max() * threshold] = 0.0
        num_pos = len(np.flatnonzero(evals))
        if truncate:
            evals = evals[-num_pos:]
            evecs = evecs[:, -num_pos:]
        root = evecs * evals[np.newaxis, :] ** 0.5

    if truncate:
        return root, num_pos
    return root


def batch_matrix_root(mats, threshold=1e-16):
    """Batched PSD matrix root via eigh with eigenvalue clipping (jittable).

    Parameters
    ----------
    mats : jnp.ndarray[..., n, n]
        Batch of symmetric PSD(-ish) matrices.
    threshold : float
        Eigenvalues below ``threshold * max_eigenvalue`` (per matrix) are
        zeroed before taking the square root.

    Returns
    -------
    roots : jnp.ndarray[..., n, n]
        Matrices R with R @ R.T == mats (up to clipped modes).
    """
    evals, evecs = jnp.linalg.eigh(mats)
    emax = jnp.max(evals, axis=-1, keepdims=True)
    evals = jnp.where(evals > emax * threshold, evals, 0.0)
    return evecs * jnp.sqrt(evals)[..., None, :]


def batch_cholesky_root(mats, jitter_rel=1e-14, threshold=1e-16):
    """Batched matrix root: Cholesky with per-matrix jitter, eigh fallback.

    Jittable equivalent of the reference's per-ell loop (skysim.py:114-121):
    adds ``jitter_rel * max(diag)`` to the diagonal, attempts Cholesky, and
    for matrices where it produced non-finite entries substitutes the
    clipped-eigh root.  Selection is via ``jnp.where`` — no Python branches.
    """
    n = mats.shape[-1]
    dmax = jnp.max(jnp.abs(jnp.diagonal(mats, axis1=-2, axis2=-1)), axis=-1)
    eye = jnp.eye(n, dtype=mats.dtype)
    jmat = mats + (jitter_rel * dmax)[..., None, None] * eye

    chol = jnp.linalg.cholesky(jmat)
    ok = jnp.all(jnp.isfinite(chol), axis=(-2, -1))

    eroot = batch_matrix_root(jmat, threshold=threshold)
    return jnp.where(ok[..., None, None], jnp.where(jnp.isfinite(chol), chol, 0.0), eroot)


def complex_std_normal(key, shape, dtype=jnp.float64):
    """Complex standard normal variates: unit total variance per element.

    Keyed-RNG replacement for the reference nputil.py:104-125 (which used the
    global numpy RNG); matches the statistics, not the stream.
    """
    kr, ki = jax.random.split(key)
    re = jax.random.normal(kr, shape, dtype=dtype)
    im = jax.random.normal(ki, shape, dtype=dtype)
    return (re + 1.0j * im) / jnp.sqrt(jnp.asarray(2.0, dtype=dtype))


def save_ndarray_list(fname, la):
    """Persist an ordered list of arrays (reference cora/util/nputil.py:12).

    Stored as an npz keyed by the list index so `load_ndarray_list`
    restores the exact ordering.
    """
    np.savez(fname, **{repr(i): v for i, v in enumerate(la)})


def load_ndarray_list(fname):
    """Load a list saved by :func:`save_ndarray_list`
    (reference cora/util/nputil.py:30)."""
    with np.load(fname) as d:
        return [v for _, v in sorted(d.items(), key=lambda kv: int(kv[0]))]
