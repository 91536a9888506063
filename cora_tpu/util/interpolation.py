"""Natural cubic-spline interpolation on device.

Functional re-design of the reference Cython interpolants
(cora/util/cubicspline.pyx:38,254,291 in the reference tree).  Semantics are
matched exactly:

* natural boundary conditions (y''[0] = y''[-1] = 0), Numerical-Recipes
  tridiagonal solve for the second derivatives;
* linear extrapolation beyond both ends using the end-interval secant slope
  corrected by the adjacent second derivative (cubicspline.pyx:144-155);
* ``LogSpline`` interpolates in (log x, log y) space
  (cubicspline.pyx:254-288), ``SinhSpline`` in arcsinh-scaled space
  (cubicspline.pyx:291-342).

The split is accelerator-idiomatic: coefficient *construction* happens on the host in
float64 numpy (these are static tables, like model weights), while
*evaluation* is pure ``jnp`` — jit/vmap/grad-compatible, with the interval
search as a vectorised ``searchsorted`` instead of the reference's per-point
OpenMP bisection loop.  Splines are registered as pytrees so they can be
closed over or passed through ``jax.jit`` boundaries.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class InterpolationException(Exception):
    """Exceptions in the interpolation module."""


def natural_spline_coefficients(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Second derivatives ``y2`` of the natural cubic spline through (x, y).

    Host-side float64 Thomas solve of the NR tridiagonal system.  Returns an
    array shaped like ``x`` with ``y2[0] == y2[-1] == 0``.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 4:
        raise InterpolationException(
            "Cubic spline interpolation requires at least 4 points."
        )
    if np.isinf(x).any() or np.isnan(x).any() or np.isinf(y).any() or np.isnan(y).any():
        raise InterpolationException("Some values invalid.")

    h = np.diff(x)  # length n-1
    # Interior system for y2[1..n-2]
    diag = (x[2:] - x[:-2]) / 3.0
    lower = h[1:-1] / 6.0  # sub-diagonal (for rows 1..)
    upper = h[1:-1] / 6.0  # super-diagonal (for rows ..-2)
    rhs = (y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1]

    m = n - 2
    # Thomas algorithm
    cp = np.empty(m)
    dp = np.empty(m)
    cp[0] = upper[0] / diag[0] if m > 1 else 0.0
    dp[0] = rhs[0] / diag[0]
    for i in range(1, m):
        denom = diag[i] - lower[i - 1] * cp[i - 1]
        cp[i] = upper[i] / denom if i < m - 1 else 0.0
        dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / denom
    z = np.empty(m)
    z[-1] = dp[-1]
    for i in range(m - 2, -1, -1):
        z[i] = dp[i] - cp[i] * z[i + 1]

    y2 = np.zeros(n)
    y2[1:-1] = z
    return y2


def spline_eval_np(x_grid, y_grid, y2, x):
    """Numpy (host, float64) spline evaluation — same semantics as spline_eval.

    Setup/table-building paths use this so they stay float64 regardless of
    the global ``jax_enable_x64`` setting.
    """
    x_grid = np.asarray(x_grid, dtype=np.float64)
    y_grid = np.asarray(y_grid, dtype=np.float64)
    y2 = np.asarray(y2, dtype=np.float64)
    scalar = np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))

    if x.size >= 4096:
        # large batches go through the native C++ kernel (same semantics,
        # single fused pass; reference uses Cython+OpenMP here)
        from .. import native

        out = native.spline_eval(x_grid, y_grid, y2, x)
        if out is not None:
            return out

    n = x_grid.shape[0]
    with np.errstate(invalid="ignore", over="ignore"):
        kl = np.clip(np.searchsorted(x_grid, x, side="right") - 1, 0, n - 2)
        kh = kl + 1

        xl, xh = x_grid[kl], x_grid[kh]
        yl, yh = y_grid[kl], y_grid[kh]
        h = xh - xl
        a = (xh - x) / h
        b = (x - xl) / h
        c = (a**3 - a) * h**2 / 6.0
        d = (b**3 - b) * h**2 / 6.0
        out = a * yl + b * yh + c * y2[kl] + d * y2[kh]

        h0 = x_grid[1] - x_grid[0]
        s0 = (y_grid[1] - y_grid[0]) / h0
        low = (s0 - h0 * y2[1] / 6.0) * (x - x_grid[0]) + y_grid[0]

        h1 = x_grid[n - 1] - x_grid[n - 2]
        s1 = (y_grid[n - 1] - y_grid[n - 2]) / h1
        high = (s1 + h1 * y2[n - 2] / 6.0) * (x - x_grid[n - 1]) + y_grid[n - 1]

        out = np.where(
            x < x_grid[0], low, np.where(x >= x_grid[n - 1], high, out)
        )
    return out[0] if scalar else out


def _is_host_value(x):
    """True if ``x`` is a plain numpy/python value (not a JAX array/tracer)."""
    return isinstance(x, (np.ndarray, np.floating, np.integer, float, int, list))


def spline_eval(x_grid, y_grid, y2, x):
    """Evaluate a natural cubic spline at ``x`` (jnp, vectorised).

    Matches the reference evaluation (cubicspline.pyx:126-175) including the
    linear extrapolation rules at both ends.
    """
    x_grid = jnp.asarray(x_grid)
    y_grid = jnp.asarray(y_grid)
    y2 = jnp.asarray(y2)
    x = jnp.asarray(x)

    n = x_grid.shape[0]

    kl = jnp.clip(jnp.searchsorted(x_grid, x, side="right") - 1, 0, n - 2)
    kh = kl + 1

    xl = x_grid[kl]
    xh = x_grid[kh]
    yl = y_grid[kl]
    yh = y_grid[kh]
    y2l = y2[kl]
    y2h = y2[kh]

    h = xh - xl
    a = (xh - x) / h
    b = (x - xl) / h
    c = (a**3 - a) * h**2 / 6.0
    d = (b**3 - b) * h**2 / 6.0
    interior = a * yl + b * yh + c * y2l + d * y2h

    # Low-end linear extrapolation: slope from first interval, corrected by y2[1]
    h0 = x_grid[1] - x_grid[0]
    s0 = (y_grid[1] - y_grid[0]) / h0
    low = (s0 - h0 * y2[1] / 6.0) * (x - x_grid[0]) + y_grid[0]

    # High-end linear extrapolation
    h1 = x_grid[n - 1] - x_grid[n - 2]
    s1 = (y_grid[n - 1] - y_grid[n - 2]) / h1
    high = (s1 + h1 * y2[n - 2] / 6.0) * (x - x_grid[n - 1]) + y_grid[n - 1]

    return jnp.where(
        x < x_grid[0], low, jnp.where(x >= x_grid[n - 1], high, interior)
    )


def _stack_data(data1, data2=None):
    if data2 is None:
        data = np.asarray(data1, dtype=np.float64)
    else:
        try:
            data = np.dstack((np.asarray(data1), np.asarray(data2)))[0].astype(
                np.float64
            )
        except ValueError as e:
            raise InterpolationException("Failure stacking x and y data.") from e

    if data.ndim != 2:
        raise InterpolationException("Array must be 2d.")
    if data.shape[1] != 2:
        raise InterpolationException("Array must consist of X-Y pairs.")
    if data.shape[0] < 4:
        raise InterpolationException(
            "Cubic spline interpolation requires at least 4 points."
        )
    if np.isinf(data).any() or np.isnan(data).any():
        raise InterpolationException("Some values invalid.")
    return data


@jax.tree_util.register_pytree_node_class
class CubicSpline:
    """Natural cubic-spline interpolant (pytree; callable under jit/vmap)."""

    def __init__(self, data1, data2=None, *, _raw=None):
        if _raw is not None:
            self.x, self.y, self.y2 = _raw
            return
        data = _stack_data(data1, data2)
        self.x = np.ascontiguousarray(data[:, 0])
        self.y = np.ascontiguousarray(data[:, 1])
        self.y2 = natural_spline_coefficients(self.x, self.y)

    @classmethod
    def fromfile(cls, file, colspec=None):
        """Build an interpolant from a whitespace-separated two-column file."""
        if colspec is None:
            colspec = [0, 1]
        if len(colspec) != 2:
            raise InterpolationException("Can only use two columns.")
        d1 = np.loadtxt(file, usecols=colspec)
        return cls(d1)

    def value(self, x):
        if _is_host_value(x):
            return spline_eval_np(self.x, self.y, self.y2, x)
        return spline_eval(self.x, self.y, self.y2, x)

    def __call__(self, x):
        return self.value(x)

    def data(self):
        return (np.dstack((self.x, self.y))[0], self.y2)

    # pytree protocol
    def tree_flatten(self):
        return (self.x, self.y, self.y2), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(None, _raw=children)


# Backwards-compatible alias matching the reference class name.
Interpolater = CubicSpline


@jax.tree_util.register_pytree_node_class
class LogSpline:
    """Cubic spline in (log x, log y) space (reference LogInterpolater)."""

    def __init__(self, data, *, _raw=None):
        if _raw is not None:
            self._spline = _raw[0]
            return
        data = np.asarray(data, dtype=np.float64)
        if np.any(data <= 0):
            raise InterpolationException("Data must be non-negative.")
        self._spline = CubicSpline(np.log(data))

    @classmethod
    def fromfile(cls, file, colspec=None):
        if colspec is None:
            colspec = [0, 1]
        d1 = np.loadtxt(file, usecols=colspec)
        return cls(d1)

    def value(self, x):
        if _is_host_value(x):
            xa = np.asarray(x, dtype=np.float64)
            if xa.size >= 4096 and xa.ndim and np.all(xa > 0):
                from .. import native

                out = native.spline_eval_log(
                    self._spline.x, self._spline.y, self._spline.y2, xa
                )
                if out is not None:
                    return out
            with np.errstate(divide="ignore"):
                return np.exp(
                    spline_eval_np(
                        self._spline.x, self._spline.y, self._spline.y2,
                        np.log(xa),
                    )
                )
        return jnp.exp(self._spline.value(jnp.log(x)))

    def __call__(self, x):
        return self.value(x)

    def tree_flatten(self):
        return (self._spline,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(None, _raw=children)


LogInterpolater = LogSpline


@jax.tree_util.register_pytree_node_class
class SinhSpline:
    """Cubic spline in arcsinh-scaled space (reference SinhInterpolater).

    Interpolates in ``arcsinh(x / x_t)`` / ``arcsinh(f / f_t)`` space; log-like
    for |values| above the thresholds, linear below — handles zeros and
    negative values.
    """

    def __init__(self, data, x_t=None, f_t=None, *, _raw=None):
        if _raw is not None:
            self._spline, self.x_t, self.f_t = _raw
            return
        if x_t is None or f_t is None:
            raise InterpolationException("Thresholds x_t and f_t are required.")
        self.x_t = float(x_t)
        self.f_t = float(f_t)
        data = np.asarray(data, dtype=np.float64)
        thresholds = np.array([self.x_t, self.f_t], dtype=np.float64)
        self._spline = CubicSpline(np.arcsinh(data / thresholds))

    def value(self, x):
        if _is_host_value(x):
            return self.f_t * np.sinh(
                spline_eval_np(
                    self._spline.x,
                    self._spline.y,
                    self._spline.y2,
                    np.arcsinh(np.asarray(x, dtype=np.float64) / self.x_t),
                )
            )
        return self.f_t * jnp.sinh(self._spline.value(jnp.arcsinh(x / self.x_t)))

    def __call__(self, x):
        return self.value(x)

    def tree_flatten(self):
        return (self._spline, self.x_t, self.f_t), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(None, _raw=children)


SinhInterpolater = SinhSpline
