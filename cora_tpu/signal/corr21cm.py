"""21cm brightness-temperature signal models.

Re-design of the reference ``cora/signal/corr21cm.py``: the ``Corr21cm``
model combines the redshift-space correlation engine with the full-sky
synthesis template (`Sky3d`), using the shipped z=1.5 matter power spectrum
with a Gaussian k* = 5 h/Mpc suppression (reference corr21cm.py:19-34), the
0.39 mK mean brightness temperature scaling (corr21cm.py:37-62), and Pade
growth approximations.
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants
from ..core import maps
from ..util import interpolation as cs
from . import corr

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


class Corr21cm(corr.RedshiftCorrelation, maps.Sky3d):
    r"""Correlation function of HI brightness-temperature fluctuations.

    Incorporates approximations for the growth factor and growth rate
    (arXiv:1012.2671 Pade forms).
    """

    add_mean = False

    _kstar = 5.0

    # C_l(ν, ν′) grid method for getsky/getalms: "clfast" evaluates the
    # channel-integrated grid through the DCT lookup table with exact
    # per-channel sinc² windows — measured MORE accurate than the
    # reference's Romberg channel integration at any tested order
    # (8e-4 vs 2.1e-2 relative at the worst point; BASELINE.md) and far
    # cheaper: the Romberg path costs 2·(2^zromb+1)² aps evaluations of
    # the full (l, nz, nz) grid.  "romberg" restores the reference-shaped
    # path (core/skysim.clarray with zromb=self.oversample).
    clarray_method = "clfast"

    def _clarray(self, lmax=None):
        from . import clfast

        nu = np.asarray(self.nu_pixels)
        if self.clarray_method != "clfast" or nu.size < 2:
            return super()._clarray(lmax)
        if lmax is None:
            lmax = 3 * self.nside - 1
        window = "exact" if self.oversample else "none"
        tables = clfast.build_cl_tables(
            self, nu, dtype=np.float64, window=window
        )
        return clfast.cl_grid_np(tables, lmax)

    def getsky(self, key=None):
        """Unpolarised sky cube; device-built covariance on accelerators.

        On accelerator backends the whole setup pipeline — P(k) grid, DCT
        tables, C_l grid, per-ell covariance roots — runs as jitted device
        programs in float64 (clfast.device_roots): the
        only host↔device traffic is a ~100 kB spline-knot upload, versus
        minutes of host DCT/eigh plus a multi-hundred-MB roots transfer.
        Falls back to the host path (Sky3d.getsky) on CPU, for ps_2d
        models, or when the model's P(k) is not device-representable.
        """
        sky = self._getsky_device(key)
        if sky is None:
            return super().getsky(key)
        return self.mean_nu(self.nu_pixels)[:, np.newaxis] + sky

    def _getsky_device(self, key=None):
        import jax

        from ..core import skysim
        from . import clfast

        nu = np.asarray(self.nu_pixels)
        if (
            jax.default_backend() == "cpu"
            or self.clarray_method != "clfast"
            or self.ps_2d
            or nu.size < 2
        ):
            return None
        lmax = 3 * self.nside - 1
        try:
            roots = clfast.device_roots(
                self, nu, lmax, window="exact" if self.oversample else "none"
            )
        except ValueError:
            return None
        parts = [
            m
            for _, m in skysim.mkfullsky_streamed(
                None, self.nside, key=self._key(key),
                fchunk=min(16, nu.size), roots=roots,
            )
        ]
        return np.concatenate(parts, axis=0)[: nu.size]

    def __init__(self, ps=None, redshift=0.0, sigma_v=0.0, **kwargs):
        if ps is None:
            redshift = 1.5
            data = np.load(os.path.join(_DATA_DIR, "ps_z1.5.npz"))
            c1 = cs.LogSpline(np.dstack((data["k"], data["ps"]))[0])
            ps = lambda k: np.exp(-0.5 * k**2 / self._kstar**2) * np.asarray(c1(k))

        self._sigma_v = sigma_v

        corr.RedshiftCorrelation.__init__(self, ps_vv=ps, redshift=redshift)
        self._load_cache(os.path.join(_DATA_DIR, "corr_z1.5.npz"))

    def T_b(self, z):
        r"""Mean 21cm brightness temperature at redshift z, in K.

        0.39 mK normalisation (reference corr21cm.py:51-62).
        """
        z = np.asarray(z, dtype=np.float64)
        return (
            3.9e-4
            * (
                (self.cosmology.omega_m + self.cosmology.omega_l * (1 + z) ** -3)
                / 0.29
            )
            ** -0.5
            * ((1.0 + z) / 2.5) ** 0.5
            * (self.omega_HI(z) / 1e-3)
        )

    def mean(self, z):
        if self.add_mean:
            return self.T_b(z)
        return np.zeros_like(np.asarray(z, dtype=np.float64))

    def omega_HI(self, z):
        """Neutral hydrogen fraction; arXiv:1304.3712 best fit."""
        return 6.2e-4

    def x_h(self, z):
        """Neutral hydrogen fraction at redshift z (constant placeholder)."""
        return 1e-3

    def prefactor(self, z):
        return self.T_b(z)

    def growth_factor(self, z):
        """Pade approximation to the matter growth factor (arXiv:1012.2671)."""
        x = ((1.0 / self.cosmology.omega_m) - 1.0) / (
            1.0 + np.asarray(z, dtype=np.float64)
        ) ** 3
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return (1.0 + x) ** 0.5 / (1.0 + np.asarray(z)) * num / den

    def growth_rate(self, z):
        """Pade approximation to the matter growth rate (arXiv:1012.2671)."""
        x = ((1.0 / self.cosmology.omega_m) - 1.0) / (
            1.0 + np.asarray(z, dtype=np.float64)
        ) ** 3
        dnum = 3.0 * x * (1.175 + 0.6127 * x + 0.01607 * x**2)
        dden = 3.0 * x * (1.857 + 2.042 * x + 0.4590 * x**2)
        num = 1.0 + 1.175 * x + 0.3064 * x**2 + 0.005355 * x**3
        den = 1.0 + 1.857 * x + 1.021 * x**2 + 0.1530 * x**3
        return 1.0 + 1.5 * x / (1.0 + x) + dnum / num - dden / den

    def bias_z(self, z):
        """HI bias; unity for the intensity-mapping regime."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def angular_powerspectrum(self, l, nu1, nu2, redshift=False):
        """C_l between two frequencies (MHz) or redshifts.

        Parameters
        ----------
        l : np.ndarray
            Multipoles.
        nu1, nu2 : np.ndarray
            Frequencies in MHz (or redshifts if ``redshift=True``).
        """
        if not redshift:
            z1 = constants.nu21 / np.asarray(nu1, dtype=np.float64) - 1.0
            z2 = constants.nu21 / np.asarray(nu2, dtype=np.float64) - 1.0
        else:
            z1, z2 = nu1, nu2
        return corr.RedshiftCorrelation.angular_powerspectrum(self, l, z1, z2)

    def mean_nu(self, freq):
        return self.mean(constants.nu21 / np.asarray(freq, dtype=np.float64) - 1.0)

    def getfield(self, key=None):
        """Fetch a flat-sky realisation cube of the 21cm signal."""
        z1 = constants.nu21 / self.nu_upper - 1.0
        z2 = constants.nu21 / self.nu_lower - 1.0

        cube = self.realisation(
            z1,
            z2,
            self.x_width,
            self.y_width,
            self.nu_num,
            self.x_num,
            self.y_num,
            zspace=False,
            key=key,
        )[::-1, :, :].copy()
        return cube

    def get_kiyo_field(self, refinement=1, key=None):
        """Fetch a realisation of the 21cm signal (in K)."""
        z1 = constants.nu21 / self.nu_upper - 1.0
        z2 = constants.nu21 / self.nu_lower - 1.0
        return self.realisation(
            z1,
            z2,
            self.x_width,
            self.y_width,
            self.nu_num,
            self.x_num,
            self.y_num,
            refinement=refinement,
            zspace=False,
            key=key,
        )

    def get_pwrspec(self, k_vec):
        """Power spectrum of the signal averaged over the band."""
        z1 = constants.nu21 / self.nu_upper - 1.0
        z2 = constants.nu21 / self.nu_lower - 1.0
        return self.powerspectrum_1D(k_vec, z1, z2, 256)

    def get_kiyo_field_physical(
        self,
        refinement=1,
        density_only=False,
        no_mean=False,
        no_evolution=False,
        key=None,
    ):
        """Fetch a realisation plus the physical-coordinate cube (in K)."""
        z1 = constants.nu21 / self.nu_upper - 1.0
        z2 = constants.nu21 / self.nu_lower - 1.0
        return self.realisation(
            z1,
            z2,
            self.x_width,
            self.y_width,
            self.nu_num,
            self.x_num,
            self.y_num,
            refinement=refinement,
            zspace=False,
            report_physical=True,
            density_only=density_only,
            no_mean=no_mean,
            no_evolution=no_evolution,
            key=key,
        )


class EoR21cm(Corr21cm):
    """Epoch-of-Reionisation flavoured 21cm model.

    Santos, Ferramacho & Silva (2009) mean temperature, higher Omega_HI and
    bias (reference corr21cm.py:333-385).
    """

    def T_b(self, z):
        z = np.asarray(z, dtype=np.float64)
        h = self.cosmology.H0 / 100.0
        return (
            23e-3
            * (self.cosmology.omega_b * h**2 / 0.02)
            * (0.15 / (self.cosmology.omega_m * h**2) * ((1.0 + z) / 10)) ** 0.5
            * (h / 0.7) ** -1
        )

    def omega_HI(self, z):
        return 5e-3

    def x_h(self, z):
        return 0.25

    def bias_z(self, z):
        """EoR bias ~3 (Santos 2004, arXiv:astro-ph/0408515)."""
        return np.ones_like(np.asarray(z, dtype=np.float64)) * 3.0
