"""Redshift-space correlations and angular power spectra.

Re-design of the reference ``cora/signal/corr.py``.  The core deliverable is
the flat-sky angular power spectrum C_l(z1, z2) (reference
``angular_powerspectrum_fft``, corr.py:891-986): a DCT-I lookup table over a
(log kperp × linear kpar) grid combined with Kaiser redshift-space factors.

Architecture notes (accelerator-first):

* Table *construction* is a one-time host computation (numpy float64) — the
  tables are static model state, like weights.
* Table *lookup* has two backends: a host numpy path (float64, used for
  golden-accuracy C_l evaluation and small configs) and a jittable JAX path
  (`angular_powerspectrum_device`) used inside the on-device synthesis
  program.
* The dead exact-integration path in the reference (corr.py:777-866, missing
  ``sphfunc``/``scipy.integrate.chebyshev``) is replaced by a *working*
  native quadrature (`xi_integrate`) based on ``scipy.special.spherical_jn``,
  used by ``gen_cache`` to build correlation-function tables.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .. import constants
from ..cosmology import Cosmology
from ..util import interpolation as cs
from ..util import bilinear


# Process-wide memo of built DCT lookup tables (read-only after build),
# keyed by grid parameters + a hash of a ps_vv probe — see _build_fft_cache.
_FFT_TABLE_MEMO = {}


def _legendre_pl(l, x):
    """Legendre polynomial P_l(x) for small fixed l (vectorised)."""
    x = np.asarray(x, dtype=np.float64)
    if l == 0:
        return np.ones_like(x)
    if l == 2:
        return 0.5 * (3 * x**2 - 1)
    if l == 4:
        return 0.125 * (35 * x**4 - 30 * x**2 + 3)
    from scipy.special import eval_legendre

    return eval_legendre(l, x)


def xi_integrate(r, l, psfunc, rel_tol=1e-7):
    """Correlation-function multipole integral.

    .. math:: \\xi_l(r) = \\frac{1}{2\\pi^2}\\int dk\\,k^2 j_l(kr) P(k)

    Native replacement for the reference's dead ``_integrate``
    (corr.py:994-1050): log-spaced quadrature up to the oscillatory regime,
    then a 5-point Longman-style offset filter over the j_l oscillations to
    accelerate convergence of the tail.
    """
    from scipy.integrate import quad
    from scipy.special import spherical_jn

    r = np.atleast_1d(np.asarray(r, dtype=np.float64))
    out = np.empty_like(r)

    def _lin(k, rr):
        return 1.0 / (2 * np.pi**2) * k**2 * spherical_jn(l, k * rr) * psfunc(k)

    for i, rr in enumerate(r):
        d = math.pi / rr
        mink, cutk, maxk = 1e-4 * d, 5e1 * d, 1e3 * d

        def _log(lk, rr=rr):
            k = math.exp(lk)
            return k * _lin(k, rr)

        def _taper(k, rr=rr, d=d):
            return (
                15.0 * _lin(k, rr)
                + 11.0 * _lin(k + d, rr)
                + 5.0 * _lin(k + 2 * d, rr)
                + _lin(k + 3 * d, rr)
            ) / 16.0

        def _offset(k, rr=rr, d=d):
            return (
                _lin(k, rr)
                + 4 * _lin(k + d, rr)
                + 6 * _lin(k + 2 * d, rr)
                + 4 * _lin(k + 3 * d, rr)
                + _lin(k + 4 * d, rr)
            ) / 16.0

        r1 = quad(_log, math.log(mink), math.log(cutk), limit=1000, epsrel=rel_tol)[0]
        r2 = quad(_taper, cutk, cutk + d, limit=1000, epsrel=rel_tol)[0]
        r3 = quad(_offset, cutk, maxk, limit=1000, epsrel=rel_tol)[0]
        out[i] = r1 + r2 + r3

    return out if out.size > 1 else out[0]


def inverse_approx(f, x1, x2, num=1000):
    """Tabulate-and-spline inverse of a monotonic function on [x1, x2]."""
    xa = np.linspace(x1, x2, num)
    fa = f(xa)
    return cs.CubicSpline(np.dstack((fa, xa))[0])


class RedshiftCorrelation:
    r"""Redshift-space correlations of a biased tracer field.

    Parameters
    ----------
    ps_vv : callable, optional
        Velocity (matter) power spectrum P(k) [k in h/Mpc].
    ps_dd, ps_dv : callable, optional
        Observable auto- and cross-spectra; if not given, the observable is
        ``bias`` times the velocity field ("vv_only" mode).
    redshift : float
        Redshift at which the input power spectra are defined.
    bias : float
        Constant linear bias (vv_only mode).
    """

    ps_vv = None
    ps_dd = None
    ps_dv = None

    ps_2d = False

    ps_redshift = 0.0
    bias = 1.0

    _vv_only = True

    _cached = False
    _xi_tables = None  # {(species, ell): CubicSpline over r}

    cosmology = Cosmology()

    # Flat-sky FFT lookup-table parameters (reference corr.py:909-913)
    _kperpmin = 1e-4
    _kperpmax = 40.0
    _nkperp = 500
    _kparmax = 20.0
    _nkpar = 32768

    _freq_window = 0.0

    def __init__(self, ps_vv=None, ps_dd=None, ps_dv=None, redshift=0.0, bias=1.0):
        self.ps_vv = ps_vv
        self.ps_dd = ps_dd
        self.ps_dv = ps_dv
        self.ps_redshift = redshift
        self.bias = bias
        self._vv_only = False if (ps_dd and ps_dv) else True
        self._aps_cache = False

    # ------------------------------------------------------------------
    # Construction helpers
    # ------------------------------------------------------------------

    @classmethod
    def from_file_matterps(cls, fname, redshift=0.0, bias=1.0):
        """Initialise from a cached single-power-spectrum table file."""
        rc = cls(redshift=redshift, bias=bias)
        rc._vv_only = True
        rc._load_cache(fname)
        return rc

    @classmethod
    def from_file_fullps(cls, fname, redshift=0.0):
        """Initialise from a cached multi-power-spectrum table file."""
        rc = cls(redshift=redshift)
        rc._vv_only = False
        rc._load_cache(fname)
        return rc

    # table columns, in the reference text-file column order after r
    _XI_COLUMNS = (("vv", 0), ("vv", 2), ("vv", 4), ("dd", 0), ("dv", 0), ("dv", 2))

    def _set_xi_tables(self, ra, cols):
        """Install the radial-moment splines from {(species, ell): values}."""
        need = self._XI_COLUMNS[:3] if self._vv_only else self._XI_COLUMNS
        missing = [k for k in need if k not in cols]
        if missing:
            raise ValueError(f"Correlation table lacks moments {missing}.")
        self._xi_tables = {
            k: cs.CubicSpline(ra, cols[k]) for k in need
        }
        self._cached = True

    def _load_cache(self, fname):
        """Load a correlation-integral table (.npz with r/vv0/vv2/vv4[...])
        or a reference-format text table (r, vv0, vv2, vv4[, dd0, dv0, dv2])."""
        names = [f"{sp}{ell}" for sp, ell in self._XI_COLUMNS]
        if str(fname).endswith(".npz"):
            a = np.load(fname)
            ra = a["r"]
            cols = {
                k: a[n] for k, n in zip(self._XI_COLUMNS, names) if n in a
            }
        else:
            a = np.loadtxt(fname)
            ra = a[:, 0]
            cols = {
                k: a[:, 1 + i]
                for i, k in enumerate(self._XI_COLUMNS)
                if a.shape[1] > 1 + i
            }
        self._set_xi_tables(ra, cols)

    def gen_cache(self, fname=None, rmin=1e-3, rmax=1e4, rnum=1000):
        """Generate (and optionally save) the correlation-integral table."""
        ra = np.logspace(np.log10(rmin), np.log10(rmax), rnum)

        specs = {"vv": self.ps_vv, "dd": self.ps_dd, "dv": self.ps_dv}
        need = self._XI_COLUMNS[:3] if self._vv_only else self._XI_COLUMNS
        cols = {
            (sp, ell): xi_integrate(ra, ell, specs[sp]) for sp, ell in need
        }

        if fname:
            np.savez(
                fname, r=ra, **{f"{sp}{ell}": v for (sp, ell), v in cols.items()}
            )

        self._set_xi_tables(ra, cols)

    # ------------------------------------------------------------------
    # Redshift scalings — override in subclasses
    # ------------------------------------------------------------------

    def bias_z(self, z):
        """Linear bias at redshift z (constant by default)."""
        return self.bias * np.ones_like(np.asarray(z, dtype=np.float64))

    def growth_factor(self, z):
        """Growth factor D_+(z); default matter-dominated 1/(1+z)."""
        return 1.0 / (1.0 + np.asarray(z, dtype=np.float64))

    def growth_rate(self, z):
        """Growth rate f(z); default matter-dominated unity."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def prefactor(self, z):
        """Arbitrary per-redshift scaling applied to each perturbation."""
        return np.ones_like(np.asarray(z, dtype=np.float64))

    def mean(self, z):
        """Mean value of the field at redshift z."""
        return np.zeros_like(np.asarray(z, dtype=np.float64))

    _sigma_v = 0.0

    def sigma_v(self, z):
        """Pairwise velocity dispersion (stored in km/s, returned in Mpc/h)."""
        sigma_v_hinvMpc = self._sigma_v / 100.0
        return np.ones_like(np.asarray(z, dtype=np.float64)) * sigma_v_hinvMpc

    def velocity_damping(self, kpar):
        """Lorentzian velocity damping for the non-linear power spectrum."""
        return (1.0 + (kpar * self.sigma_v(self.ps_redshift)) ** 2.0) ** -1.0

    # ------------------------------------------------------------------
    # Power spectra / correlation functions
    # ------------------------------------------------------------------

    def _evolution(self, z):
        """Evolution weight of one leg of a two-point function: linear
        growth relative to the epoch the spectra are tabulated at, times
        the model's per-redshift prefactor."""
        return (
            self.growth_factor(z)
            / self.growth_factor(self.ps_redshift)
            * self.prefactor(z)
        )

    def _kaiser_weights(self, z1, z2):
        """Weights of the three density/velocity moments in the Kaiser
        expansion.

        Linear redshift-space distortions attach ``(b + f·mu²)`` to each
        leg, so every two-point quantity is a quadratic form in mu²
        contracted against (P_dd, P_dv, P_vv); this returns its mu⁰, mu²
        and mu⁴ coefficients ``(b1·b2, b1·f2 + b2·f1, f1·f2)``.
        """
        b1, b2 = self.bias_z(z1), self.bias_z(z2)
        f1, f2 = self.growth_rate(z1), self.growth_rate(z2)
        return b1 * b2, b1 * f2 + b2 * f1, f1 * f2

    def powerspectrum(self, kpar, kperp, z1=None, z2=None):
        """Redshift-space (Kaiser) power spectrum at (kpar, kperp).

        ``E1·E2·(w_dd·P_dd + mu²·w_dv·P_dv + mu⁴·w_vv·P_vv)`` with the
        moment weights of :meth:`_kaiser_weights`; a single-spectrum model
        shares one P(k) across the moments (the product form
        ``(b1 + f1·mu²)(b2 + f2·mu²)·P`` expanded).  Parity of reference
        corr.py:152-201 with its ``z == None`` array bug fixed.
        """
        if z1 is None:
            z1 = self.ps_redshift
        if z2 is None:
            z2 = self.ps_redshift

        k2 = kpar**2 + kperp**2
        k = np.sqrt(k2)
        mu2 = kpar**2 / k2

        if self._vv_only:
            pdd = pdv = pvv = (
                self.ps_vv(k, kpar / k) if self.ps_2d else self.ps_vv(k)
            )
        else:
            pdd, pdv, pvv = self.ps_dd(k), self.ps_dv(k), self.ps_vv(k)

        wdd, wdv, wvv = self._kaiser_weights(z1, z2)
        ps = wdd * pdd + mu2 * wdv * pdv + mu2**2 * wvv * pvv
        return ps * (self._evolution(z1) * self._evolution(z2))

    def powerspectrum_1D(self, k_vec, z1, z2, numz):
        """Real-space power spectrum averaged over the band [z1, z2]:
        P(k) scaled by the squared mean evolution-weighted bias over
        numz+1 slices uniform in comoving distance."""
        chi = np.linspace(
            self.cosmology.comoving_distance(z1),
            self.cosmology.comoving_distance(z2),
            numz + 1,
        )
        za = np.asarray(
            inverse_approx(self.cosmology.comoving_distance, z1, z2)(chi)
        )
        weight = np.mean(self._evolution(za) * self.bias_z(za))
        return self.ps_vv(k_vec) * weight**2

    # Flat-sky Kaiser multipoles (Hamilton 1992): the P_l(mu) expansion of
    # xi_s couples each radial moment xi^{species}_l to one moment-weight
    # channel; entries are (l, ((species, l', coefficient), ...)) with the
    # coefficients expressed against the _kaiser_weights normalisation.
    _XI_MULTIPOLES = (
        (0, (("dd", 0, 1.0), ("dv", 0, 1.0 / 3.0), ("vv", 0, 1.0 / 5.0))),
        (2, (("dv", 2, -2.0 / 3.0), ("vv", 2, -4.0 / 7.0))),
        (4, (("vv", 4, 8.0 / 35.0),)),
    )

    def _xi_moment(self, r, species, ell):
        """Radial moment xi^{species}_l(r): cached spline if the table has
        been generated/loaded, else direct Bessel-weighted quadrature.
        The single-spectrum model shares the vv moments across species."""
        if self._vv_only:
            species = "vv"
        if self._cached:
            return np.asarray(self._xi_tables[species, ell](r))
        ps = {"vv": self.ps_vv, "dd": self.ps_dd, "dv": self.ps_dv}[species]
        return xi_integrate(r, ell, ps)

    def redshiftspace_correlation(self, pi, sigma, z1=None, z2=None):
        """Flat-sky redshift-space correlation function xi(pi, sigma).

        The Kaiser-limit multipole expansion (_XI_MULTIPOLES) evaluated at
        r = (pi² + sigma²)^½, mu = pi/r; matches reference corr.py:242-348
        through the shared moment table rather than per-moment in-place
        scaling."""
        if z1 is None:
            z1 = self.ps_redshift
        if z2 is None:
            z2 = z1

        r = np.hypot(pi, sigma)
        mu = pi / (r + 1e-100)  # keeps pi = sigma = 0 finite

        w = dict(zip(("dd", "dv", "vv"), self._kaiser_weights(z1, z2)))
        xi = 0.0
        for ell, terms in self._XI_MULTIPOLES:
            pl = _legendre_pl(ell, mu) if ell else 1.0
            for species, mell, coeff in terms:
                xi = xi + (coeff * w[species] * pl) * self._xi_moment(
                    r, species, mell
                )
        return xi * (self._evolution(z1) * self._evolution(z2))

    def angular_correlation(self, theta, z1, z2):
        """Angular correlation function in the flat-sky approximation."""
        za = (z1 + z2) / 2.0
        sigma = theta * self.cosmology.proper_distance(za)
        pi = self.cosmology.comoving_distance(z2) - self.cosmology.comoving_distance(
            z1
        )
        return self.redshiftspace_correlation(pi, sigma, z1, z2)

    # ------------------------------------------------------------------
    # Flat-sky angular power spectrum via DCT lookup table
    # ------------------------------------------------------------------

    _aps_cache = False

    def _fft_table_key(self):
        """Memo key for the DCT tables: grid params + a probe of ps_vv.

        The probe spans the full |k| range the table build actually
        evaluates (k = sqrt(kperp^2 + kpar^2) over the grid) and, for 2-D
        power spectra, several mu values — so two models that differ
        anywhere on the sampled (k, mu) domain can never share a cached
        table (this key also names durable per-user disk-cache entries).
        The model class is part of the key as a belt-and-braces tag.
        """
        import hashlib

        k_lo = self._kperpmin
        k_hi = float(np.hypot(self._kperpmax, self._kparmax))
        probe_k = np.logspace(np.log10(k_lo), np.log10(k_hi), 96)
        if self.ps_2d:
            pv = np.concatenate(
                [np.asarray(self.ps_vv(probe_k, np.full(96, mu)))
                 for mu in (0.0, 0.3, 0.7, 1.0)]
            )
        else:
            pv = np.asarray(self.ps_vv(probe_k))
        h = hashlib.sha1(np.ascontiguousarray(pv, np.float64).tobytes())
        return (
            type(self).__qualname__,
            self._kperpmin, self._kperpmax, self._nkperp, self._kparmax,
            self._nkpar, float(self._freq_window), float(self.ps_redshift),
            bool(self.ps_2d), h.hexdigest(),
        )

    def _build_fft_cache(self):
        """Build the DCT-I lookup tables (host, float64, one-time).

        Built chunked over kperp rows (bounded temporaries, reused by the
        allocator) and memoised process-wide: the full (500 x 32768) grid is
        ~131 MB per array and some virtualised hosts charge ~0.5 ms per
        first-touch page fault, so every instance sharing the same
        P(k)/grid/window reuses one build instead of paying that again.
        """
        import scipy.fft

        key = self._fft_table_key()
        hit = _FFT_TABLE_MEMO.get(key)
        if hit is not None:
            self._aps_dd, self._aps_dv, self._aps_vv = hit
            self._aps_cache = True
            return

        # disk tier of the memo: the tables are a pure function of the
        # key (grid params + P(k) content hash), so they persist in the
        # table cache (<checkout>/.table_cache, or $CORA_TPU_CACHE;
        # CORA_TPU_CACHE="" disables).  At production
        # grids the build is ~2 min of host DCTs — the dominant CLI
        # cold-start term once programs come from the compile cache.
        disk_path = self._fft_table_disk_path(key)
        if disk_path is not None and os.path.exists(disk_path):
            try:
                with np.load(disk_path) as a:
                    tabs = (a["dd"], a["dv"], a["vv"])
                self._aps_dd, self._aps_dv, self._aps_vv = tabs
                _FFT_TABLE_MEMO[key] = tabs
                self._aps_cache = True
                return
            except Exception:
                pass  # corrupt/partial file: rebuild and overwrite

        kperp = np.logspace(
            np.log10(self._kperpmin), np.log10(self._kperpmax), self._nkperp
        )
        kpar = np.linspace(0, self._kparmax, self._nkpar)[np.newaxis, :]
        window = np.sinc(kpar * self._freq_window / (2 * np.pi)) ** 2

        dd = np.empty((self._nkperp, self._nkpar))
        dv = np.empty_like(dd)
        vv = np.empty_like(dd)

        norm = self._kparmax / (2 * self._nkpar)
        chunk = 32
        for i0 in range(0, self._nkperp, chunk):
            sl = slice(i0, min(i0 + chunk, self._nkperp))
            kp = kperp[sl, np.newaxis]
            k = np.sqrt(kpar**2 + kp**2)
            mu2 = (kpar / k) ** 2
            if self.ps_2d:
                d = self.ps_vv(k, kpar / k) * window
            else:
                d = self.ps_vv(k) * window
            # DCT-I over the kpar axis: projects P(kperp, kpar) onto
            # cos(kpar rpar) at rpar = pi * j / kparmax — the flat-sky
            # radial transform.
            dd[sl] = scipy.fft.dct(d, type=1)
            dv[sl] = scipy.fft.dct(d * mu2, type=1)
            vv[sl] = scipy.fft.dct(d * mu2**2, type=1)
        dd *= norm
        dv *= norm
        vv *= norm

        self._aps_dd, self._aps_dv, self._aps_vv = dd, dv, vv
        _FFT_TABLE_MEMO[key] = (dd, dv, vv)
        self._aps_cache = True

        if disk_path is not None:
            tmp = disk_path + f".tmp{os.getpid()}"
            try:
                np.savez(tmp, dd=dd, dv=dv, vv=vv)
                os.replace(tmp + ".npz", disk_path)
            except Exception:
                # cache dir unwritable/full: stay in-memory only — but do
                # not leave a partial .tmp*.npz behind
                try:
                    os.unlink(tmp + ".npz")
                except OSError:
                    pass

    def _fft_table_disk_path(self, key):
        """Per-user cache file for the DCT tables, or None if disabled."""
        import hashlib

        from ..healpix.sht import _user_cache_dir

        d = _user_cache_dir()
        if d is None:
            return None
        h = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
        return os.path.join(d, f"dct_{h}.npz")

    def save_fft_cache(self, fname):
        """Save the DCT angular power spectrum lookup tables."""
        if not self._aps_cache:
            self._build_fft_cache()
        np.savez(fname, dd=self._aps_dd, dv=self._aps_dv, vv=self._aps_vv)

    def load_fft_cache(self, fname):
        """Load DCT angular power spectrum lookup tables."""
        a = np.load(fname)
        self._aps_dd = a["dd"]
        self._aps_dv = a["dv"]
        self._aps_vv = a["vv"]
        self._aps_cache = True

    def _table_coords(self, kperp, dchi):
        """Fractional (row, col) indices of a physical point in the DCT
        tables: rows are log-spaced in k_perp over [_kperpmin, _kperpmax];
        the DCT-I column index conjugate to k_par is Δchi·k_parmax/pi
        (cosine frequency spacing pi/k_parmax)."""
        row = (self._nkperp - 1) * (
            np.log(kperp / self._kperpmin)
            / np.log(self._kperpmax / self._kperpmin)
        )
        col = dchi * (self._kparmax / np.pi)
        return row, col

    def angular_powerspectrum_fft(self, la, za1, za2):
        """Flat-sky angular power spectrum C_l(z1, z2) via table lookup.

        Limber-style flat-sky reduction (reference corr.py:891-982): the
        radial k_par integral against cos(k_par·Δchi) is the precomputed
        DCT-I table, evaluated at k_perp = l/chi_mean by bilinear lookup
        and contracted with the Kaiser moment weights; overall factor
        E1·E2/(pi·chi_mean²).
        """
        if not self._aps_cache:
            self._build_fft_cache()

        la = np.asarray(la, dtype=np.float64)
        za1 = np.asarray(za1, dtype=np.float64)
        za2 = np.asarray(za2, dtype=np.float64)

        chi1 = self.cosmology.comoving_distance(za1)
        chi2 = self.cosmology.comoving_distance(za2)
        chi_mean = 0.5 * (chi1 + chi2)

        # l = 0 would hit log(0); nudge it onto the table's low edge
        row, col = self._table_coords(
            np.where(la == 0.0, 1e-10, la) / chi_mean, np.abs(chi2 - chi1)
        )

        moments = (
            bilinear.interp2d_np(tab, row, col)
            for tab in (self._aps_dd, self._aps_dv, self._aps_vv)
        )
        cl = sum(w * m for w, m in zip(self._kaiser_weights(za1, za2), moments))
        return cl * (
            self._evolution(za1) * self._evolution(za2) / (np.pi * chi_mean**2)
        )

    def angular_powerspectrum_exact(self, la, za1, za2, resolution=1.0):
        r"""Exact (curved-sky) angular power spectrum C_l(z1, z2).

        Working replacement for the reference's dead exact path
        (``angular_powerspectrum_full``, reference corr.py:777-866 — dead
        upstream: it imports the missing ``cora.util.sphfunc`` and the
        nonexistent ``scipy.integrate.chebyshev``).  Computes, per the same
        Kaiser redshift-space integrand,

        .. math::
           C_\ell = \frac{2}{\pi} D_1 D_2 p_1 p_2 \int_0^\infty \!dk\, k^2
             P(k)\, [b_1 j_\ell(k\chi_1) - f_1 j_\ell''(k\chi_1)]
                    [b_2 j_\ell(k\chi_2) - f_2 j_\ell''(k\chi_2)]

        with :mod:`cora_tpu.util.sphfunc` Bessel recurrences.  The
        oscillatory tail is handled with the same binomial offset-average
        idea as the reference (its ``_int_offset``/``_int_taper`` weights,
        corr.py:820-845) but made *exact*: with
        :math:`\bar f(k) = \sum_j w_j f(k + j d)`, :math:`w = (1,4,6,4,1)/16`,
        :math:`d = \pi/(\chi_1+\chi_2)` (which cancels the
        :math:`\cos k(\chi_1{+}\chi_2)` component identically),

        .. math::
           \int_c^\infty f = \int_c^\infty \bar f
             + \sum_j w_j \int_c^{c+jd} f ,

        and each piece is integrated by composite Simpson at a resolution
        tied to the surviving slow oscillation :math:`\cos k|\Delta\chi|`.

        This is a host-side float64 validation-grade method (the hot C_l
        path stays the DCT lookup); cost grows like
        :math:`\mathcal{O}(\ell^2)` per (l, z1, z2) tuple.

        Parameters
        ----------
        la, za1, za2 : array_like (broadcast together)
            Multipoles and redshift-slice pairs.
        resolution : float
            Node-density multiplier for convergence studies (2.0 = twice
            as many quadrature nodes everywhere).

        Returns
        -------
        cla : ndarray
            C_l(z1, z2) at each broadcast element.
        """
        from ..util import sphfunc

        if not self._vv_only:
            raise NotImplementedError("exact C_l: vv_only mode only "
                                      "(as the reference, corr.py:797)")

        def _simpson_nodes(a, b, n):
            # composite Simpson: n odd node count
            n = int(n) | 1
            if n < 3:
                n = 3
            k = np.linspace(a, b, n)
            w = np.ones(n)
            w[1:-1:2] = 4.0
            w[2:-1:2] = 2.0
            w *= (b - a) / (n - 1) / 3.0
            return k, w

        def _cl_single(l, z1, z2):
            l = int(l)
            b1, b2 = float(self.bias_z(z1)), float(self.bias_z(z2))
            f1, f2 = float(self.growth_rate(z1)), float(self.growth_rate(z2))
            pf1, pf2 = float(self.prefactor(z1)), float(self.prefactor(z2))
            D1 = float(self.growth_factor(z1) / self.growth_factor(self.ps_redshift))
            D2 = float(self.growth_factor(z2) / self.growth_factor(self.ps_redshift))
            x1 = float(self.cosmology.comoving_distance(z1))
            x2 = float(self.cosmology.comoving_distance(z2))
            xs, dx = x1 + x2, abs(x1 - x2)
            d1 = math.pi / xs
            leff = max(l, 1)
            mink = 1e-2 * leff / xs
            cutk = 2.0 * leff / xs
            maxk = 1e2 * leff / xs

            # --- region A: pre-turnover, smooth; Simpson in log k
            nA = int(513 * resolution)
            lk, wA = _simpson_nodes(math.log(mink), math.log(cutk), nA)
            kA = np.exp(lk)
            wA = wA * kA  # d(log k) -> dk

            # --- region B: offset-averaged tail; node spacing resolves the
            # surviving cos(k|dx|) plus margin for the Airy transitions
            h = d1 / ((2.0 + 6.0 * dx / xs) * resolution)
            wgt = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0

            def _fbar_segment(a, b):
                # F_bar Simpson nodes over [a, b]: (k_samples, weights)
                kB, wB0 = _simpson_nodes(a, b, int((b - a) / h) + 1)
                kk = (kB[None, :] + d1 * np.arange(5)[:, None]).ravel()
                ww = (wgt[:, None] * wB0[None, :]).ravel()
                return kk, ww

            # --- correction: sum_j w_j * int_{cutk}^{cutk+j d1} f
            nC = int(65 * resolution)
            kCs, wCs = [], []
            for j in range(1, 5):
                kC, wC = _simpson_nodes(cutk, cutk + j * d1, nC)
                kCs.append(kC)
                wCs.append(wgt[j] * wC)

            def _eval(k, w):
                # weighted quadrature of the integrand at nodes k
                def _F(chi, b, f):
                    x = k * chi
                    rows = [0, 1] if l == 0 else [l - 1, l]
                    r = sphfunc.jl_rows(rows, x)
                    xl = r[l]
                    dj = -r[1] if l == 0 else r[l - 1] - (l + 1) / x * xl
                    d2j = -(2.0 / x) * dj + (l * (l + 1) / x**2 - 1.0) * xl
                    return b * xl - f * d2j

                integ = k**2 * self.ps_vv(k) * _F(x1, b1, f1) * _F(x2, b2, f2)
                return float(np.dot(w, integ))

            kB0, wB0 = _fbar_segment(cutk, maxk)
            cl = _eval(
                np.concatenate([kA, kB0] + kCs),
                np.concatenate([wA, wB0] + wCs),
            )

            # extend the F_bar tail in doubling blocks until it no longer
            # matters — maxk = 1e2*l/chi (the reference's cut) truncates a
            # percent-level contribution at low l where the k-window ends
            # before the P(k) turnover
            lo = maxk
            for _ in range(12):
                hi = 2.0 * lo
                block = _eval(*_fbar_segment(lo, hi))
                cl += block
                if abs(block) < 1e-8 * abs(cl) or hi > 1e3:
                    break
                lo = hi

            return cl * D1 * D2 * pf1 * pf2 * (2.0 / math.pi)

        bobj = np.broadcast(np.asarray(la), np.asarray(za1), np.asarray(za2))
        if not bobj.shape:
            return _cl_single(la, za1, za2)
        out = np.empty(bobj.shape)
        out.flat = [_cl_single(l, z1, z2) for (l, z1, z2) in bobj]
        return out

    # Reference-parity alias (the upstream name for the exact method).
    angular_powerspectrum_full = angular_powerspectrum_exact

    # Default C_l method, as in the reference (corr.py:986).
    angular_powerspectrum = angular_powerspectrum_fft

    # ------------------------------------------------------------------
    # 3D realisations (flat-sky lightcone cubes) are implemented in
    # cora_tpu.signal.realisation to keep the C_l engine lean.
    # ------------------------------------------------------------------

    def realisation(self, *args, **kwargs):
        """Simulate a redshift-space volume; see signal.realisation."""
        from . import realisation as _rlz

        return _rlz.realisation(self, *args, **kwargs)

    def _realisation_dv(self, d, n, key=None):
        from . import realisation as _rlz

        return _rlz.realisation_dv(self, d, n, key=key)
