"""Clipped 2D bilinear table lookup.

JAX replacement for the reference OpenMP kernel
(cora/util/bilinearmap.pyx:14-59): a two-axis gather + lerp, fully
vectorised/jittable.  Coordinates are in *index* units; they are clipped to
the valid table range (the reference clips to ``[0, n - 1e-5]``; we
additionally clamp the base index to ``n - 2`` so the upper gather never
reads out of bounds — in-range results are identical).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def interp2d_np(arr, x, y):
    """Host (numpy float64) variant of :func:`interp2d`."""
    arr = np.asarray(arr, dtype=np.float64)
    x, y = np.broadcast_arrays(
        np.asarray(x, dtype=np.float64), np.asarray(y, dtype=np.float64)
    )
    nx, ny = arr.shape

    xx = np.clip(x, 0.0, nx - 1e-5)
    yy = np.clip(y, 0.0, ny - 1e-5)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, nx - 2)
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, ny - 2)
    x1 = x0 + 1
    y1 = y0 + 1

    wa = (x1 - xx) * (y1 - yy)
    wb = (x1 - xx) * (yy - y0)
    wc = (xx - x0) * (y1 - yy)
    wd = (xx - x0) * (yy - y0)

    return wa * arr[x0, y0] + wb * arr[x0, y1] + wc * arr[x1, y0] + wd * arr[x1, y1]


def interp2d(arr, x, y):
    """Bilinearly interpolate ``arr`` at fractional indices (x, y).

    Parameters
    ----------
    arr : array_like [nx, ny]
        Table to interpolate.
    x, y : array_like
        Fractional index coordinates along axis 0 / axis 1 (broadcast
        together).

    Returns
    -------
    v : jnp.ndarray
        Interpolated values with the broadcast shape of x and y.
    """
    arr = jnp.asarray(arr)
    x, y = jnp.broadcast_arrays(jnp.asarray(x), jnp.asarray(y))

    nx, ny = arr.shape

    xx = jnp.clip(x, 0.0, nx - 1e-5)
    yy = jnp.clip(y, 0.0, ny - 1e-5)

    x0 = jnp.clip(jnp.floor(xx).astype(jnp.int32), 0, nx - 2)
    y0 = jnp.clip(jnp.floor(yy).astype(jnp.int32), 0, ny - 2)
    x1 = x0 + 1
    y1 = y0 + 1

    wa = (x1 - xx) * (y1 - yy)
    wb = (x1 - xx) * (yy - y0)
    wc = (xx - x0) * (y1 - yy)
    wd = (xx - x0) * (yy - y0)

    Ia = arr[x0, y0]
    Ib = arr[x0, y1]
    Ic = arr[x1, y0]
    Id = arr[x1, y1]

    return wa * Ia + wb * Ib + wc * Ic + wd * Id


def interp(arr, x, y, v=None):
    """Reference-compatible signature (bilinearmap.pyx:14); returns the result.

    When ``v`` is a mutable numpy array the result is also written into it
    (the reference kernel's only output channel — callers like
    cora/signal/corr.py:972 read ``v``, not the return value).  JAX arrays
    are immutable, so the in-place channel uses the host numpy variant.
    """
    if v is not None and isinstance(v, np.ndarray):
        v[...] = interp2d_np(arr, x, y)
        return v
    return interp2d(arr, x, y)
