"""Galactic synchrotron emission models.

Re-design of the reference ``cora/foreground/galaxy.py``: full-sky SCK
synchrotron amplitudes (La Porta et al. 2008), and the Haslam-constrained
``ConstrainedGalaxy`` with spatially varying spectral index, variance-map
modulated fluctuations, and a Faraday-screen polarised sky.

The device win here is the polarised path: the reference synthesises
1000 complex maps one at a time through healpy (galaxy.py:260-267); here
the whole φ-conjugate screen is one batched device synthesis.
"""

from __future__ import annotations

import os

import numpy as np

from ..util.compute import on_model_device
import jax
import jax.numpy as jnp

from ..core import maps, skysim
from ..healpix import pixel as hpx
from ..healpix import sht as _sht
from ..healpix import transforms as hputil
from . import gaussianfg
from . import skydata

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")


class FullSkySynchrotron(gaussianfg.Synchrotron):
    """Synchrotron amplitudes matched to La Porta et al. 2008 (|b| > 5°)."""

    A = 6.6e-3
    beta = 2.8
    nu_0 = 408.0
    l_0 = 100.0


class FullSkyPolarisedSynchrotron(gaussianfg.Synchrotron):
    """Polarised synchrotron: pol fraction 0.5, reduced correlation length
    (ζ=0.04 from RM=16.7; Taylor et al. 2009)."""

    A = 1.65e-3
    beta = 2.8
    nu_0 = 408.0
    l_0 = 100.0
    zeta = 0.04


def map_variance(input_map, nside):
    """Variance of a map within low-resolution (nside) super-pixels."""
    inp_nside = hpx.npix2nside(np.asarray(input_map).shape[-1])
    map_nest = hpx.reorder(np.asarray(input_map), r2n=True)
    map_nest = map_nest.reshape(-1, (inp_nside // nside) ** 2)
    var_map = map_nest.var(axis=1)
    return hpx.reorder(var_map, n2r=True)


def _derived_cache(tag, inp, compute, extra=""):
    """Disk-cache a derived map that is a pure function of ``inp``.

    The ConstrainedGalaxy amplitude map and Faraday window widths are
    deterministic transforms of fixed survey data, yet cost ~2 minutes of
    host f64 smoothing per process at the skydata's native resolution —
    the dominant cold cost of the polarised galaxy path.  Key: content hash of the input map (so an
    upstream-skydata override via CORA_TPU_SKYDATA gets its own entries)
    plus any extra parameters; store: the per-user table cache dir.
    """
    import hashlib

    from ..healpix.sht import _user_cache_dir

    d = _user_cache_dir()
    if d is None:
        return compute()
    h = hashlib.sha1(
        np.ascontiguousarray(np.asarray(inp)).tobytes()
    ).hexdigest()[:16]
    path = os.path.join(d, f"galaxy_{tag}_{h}{extra}.npy")
    if os.path.exists(path):
        try:
            return np.load(path)
        except Exception:
            pass
    out = np.asarray(compute())
    try:
        np.save(path, out)
    except OSError:
        pass
    return out


def chunk_var(a):
    """Memory-frugal variance over a large array."""
    a = np.asarray(a)
    nchunks = min(30, a.size)
    mean = a.mean()
    t = 0.0
    for sec in np.array_split(a.ravel(), nchunks):
        t += np.sum(np.abs(sec - mean) ** 2)
    return t / a.size


def _faraday_screen_device(op, t, key, ps_weight, nphi, corr_w, sig_grid,
                           phifreq, pta):
    """Faraday-screen polarisation as one device pipeline (grid layout).

    Draws the φ-conjugate random screen (blocked batched complex
    synthesis), applies the Gaussian φ-correlation, matmul-DFTs back into
    Faraday depth (fftmm), normalises to unit polarisation fraction,
    applies the per-pixel Faraday-depth window, contracts with the φ→ν
    transfer matrix, and tanh-saturates.  Returns (Q, U) float32 grids
    ``[nfreq, nring, W]``.

    Replaces the reference's host numpy pipeline (galaxy.py:260-313: nphi
    healpy SHT calls + an [npix, nphi]·[nphi, nfreq] complex matmul —
    ~1e11 flops single-core).
    """
    from functools import partial

    from ..healpix.sht import _synthesis_grid
    from ..ops import fftmm
    from ..util import xfer

    L = op.lmax + 1
    # block the φ-slice synthesis to bound the alm working set (≤256 MB)
    block = 1
    for b in (125, 100, 50, 40, 25, 20, 10, 8, 5, 4, 2):
        if nphi % b == 0 and b * L * L * 8 <= 2**28:
            block = b
            break
    nblk = nphi // block

    li = np.arange(L)[:, None]
    mi = np.arange(L)[None, :]
    wmask = (ps_weight[:, None] * (mi <= li)).astype(np.float32)
    wmask_d = xfer.put(wmask)
    corr_d = xfer.put(np.asarray(corr_w, dtype=np.float32))
    sig_d = xfer.put(np.asarray(sig_grid, dtype=np.float32))
    phif_d = xfer.put(np.asarray(phifreq, dtype=np.float32))
    pta_d = xfer.put(np.asarray(pta, dtype=np.complex64))
    tabs = fftmm.dft_tables(nphi, dtype=np.complex64)
    tinv = {k: xfer.put(v) for k, v in tabs["inv"].items()}
    n1, n2 = tabs["n1n2"]

    @jax.jit
    def synth_blocks(key, wmask, t):
        def blk(c, _):
            ks = jax.random.split(jax.random.fold_in(key, c), 4)
            shape = (block, L, L)
            wr = (
                jax.random.normal(ks[0], shape, jnp.float32)
                + 1j * jax.random.normal(ks[1], shape, jnp.float32)
            ) * wmask
            wi = (
                jax.random.normal(ks[2], shape, jnp.float32)
                + 1j * jax.random.normal(ks[3], shape, jnp.float32)
            ) * wmask
            # each half-m alm synthesises a real field; the complex screen
            # is synth(wr) + i·synth(wi) (statistically equivalent to the
            # reference's full-m complex construction)
            Sr = _synthesis_grid(op, t, wr.astype(jnp.complex64))
            Si = _synthesis_grid(op, t, wi.astype(jnp.complex64))
            return c + 1, jax.lax.complex(Sr, Si)

        _, cube = jax.lax.scan(blk, 0, None, length=nblk)
        return cube.reshape((nphi,) + cube.shape[2:])

    @partial(jax.jit, donate_argnums=0)
    def transfer(cube, corr_w, sig, phif, pta, W1, T, W2):
        x = cube * corr_w[:, None, None]
        x = jnp.transpose(x, (1, 2, 0))  # [nring, W, nphi]
        x = fftmm._apply(x, dict(W1=W1, T=T, W2=W2), n1, n2) / nphi
        mu = jnp.mean(x)
        v = jnp.mean(jnp.abs(x - mu) ** 2)
        x = x / (2.0 * jnp.sqrt(v))
        w = jnp.exp(-0.25 * (phif[None, None, :] / sig[:, :, None]) ** 2)
        x = x * (w / jnp.sum(w, axis=-1, keepdims=True))
        y = jnp.einsum("rwp,pf->rwf", x, pta, precision="highest")
        ya = jnp.abs(y)
        y = y * jnp.tanh(ya) / jnp.where(ya == 0.0, 1.0, ya)
        y = jnp.transpose(y, (2, 0, 1))  # [nfreq, nring, W]
        return (
            jnp.real(y).astype(jnp.float32),
            jnp.imag(y).astype(jnp.float32),
        )

    cube = synth_blocks(key, wmask_d, t)
    return transfer(cube, corr_d, sig_d, phif_d, pta_d,
                    tinv["W1"], tinv["T"], tinv["W2"])


class ConstrainedGalaxy(maps.Sky3d):
    """Realistic galactic synchrotron simulations constrained to Haslam.

    Attributes
    ----------
    spectral_map : {'md', 'gsm', 'gd'}
        Spectral-index map variant (Miville-Deschenes 2008 default, GSM
        derived, or Giardino 2002).
    seed : int or None
        RNG seed.

    Notes
    -----
    The shipped sky maps are *synthetic statistical stand-ins* regenerated
    by tools/make_skydata.py (the upstream data blob is stripped from the
    reference checkout); to use the real Haslam/spectral/Faraday maps, point
    the ``CORA_TPU_SKYDATA`` env var at the upstream ``skydata.npz`` (the
    key schema matches — see cora_tpu.foreground.skydata).
    """

    spectral_map = "md"

    _dphi = 1.0
    _maxphi = 500.0

    @on_model_device
    def __init__(self):
        # model-device scope: the f64 smoothing/analysis here must build its
        # SHT tables on the host CPU device inside accelerator processes,
        # matching the (also model-device) getsky/getpolsky calls, so the
        # cached SHT tables are committed to one device.
        self._load_data()

        def _build_amp_map():
            vm = map_variance(
                _sht.smoothing(self._haslam, sigma=np.radians(0.5)), 16
            )
            return _sht.smoothing(
                hpx.ud_grade(np.asarray(vm) ** 0.5, self._data_nside),
                sigma=np.radians(2.0),
            )

        self._amp_map = _derived_cache("ampmap", self._haslam, _build_amp_map)

    def _load_data(self):
        f = skydata.load_skydata()
        self._haslam = f["haslam"]
        self._sp_ind = {
            "gsm": f["spectral_gsm"],
            "md": f["spectral_md"],
            "gd": f["spectral_gd"],
        }
        self._faraday = f["faraday"]
        self._data_nside = hpx.npix2nside(self._haslam.shape[-1])

    @on_model_device
    def getsky(self, debug=False, celestial=True, key=None):
        """Realisation of the *unpolarised* sky [freq, pixel] (K).

        Haslam-constrained: random SCK fluctuations constrained to match
        the smoothed Haslam map at 408 MHz, modulated by a local variance
        map, rescaled by the spectral-index map, with tanh-linear
        positivity (reference galaxy.py:133-207).
        """
        key = self._key(key)
        haslam = hpx.ud_grade(self._haslam, self.nside)

        syn = FullSkySynchrotron()
        lmax = 3 * self.nside - 1
        efreq = np.concatenate((np.array([408.0, 1420.0]), self.nu_pixels))

        cla = skysim.clarray(syn.angular_powerspectrum, lmax, efreq, zromb=0)

        from ..util.compute import accel_device

        # realisation + beam smoothings escape the model_device (CPU)
        # region onto the accelerator: random SCK fields are statistical
        # (f32 synthesis is exact-class for the 1e-5 contract) and the
        # smoothed maps here are red-spectrum, where the beam-limited
        # grid smoothing is few-1e-4 accurate (sht.smoothing_grid notes).
        # The eigh-heavy constrained solve (mkconstrained) stays on host.
        with accel_device():
            fg = skysim.mkfullsky(cla, self.nside, key=key)
            sub408 = _sht.smoothing_grid(fg[0], fwhm=np.radians(1.0))
            sub1420 = _sht.smoothing_grid(fg[1], fwhm=np.radians(5.8))

            # mkconstrained's eigh/solve are host-numpy f64 regardless of
            # placement; running it inside the accel scope moves only its
            # SHT legs (constraint analysis + constrained synthesis) onto
            # the device in f32 — measured 11 s/call of host f64
            # transforms in the steady state at nside=128 × 64 ch
            if self.spectral_map == "gsm":
                fgs = skysim.mkconstrained(
                    cla, [(0, sub408), (1, sub1420)], self.nside
                )
            else:
                fgs = skysim.mkconstrained(cla, [(0, sub408)], self.nside)

        sc = hpx.ud_grade(self._sp_ind[self.spectral_map], self.nside)
        am = hpx.ud_grade(self._amp_map, self.nside)

        with accel_device():
            vm = _sht.smoothing_grid(fg[0], sigma=np.radians(0.5))
        # variance in nside-16 super-pixels (reference galaxy.py:158);
        # clamp the window resolution so each window holds >= 4 pixels at
        # small model nside (a 1-pixel window has zero variance and the
        # amplitude normalisation below blows up)
        var_nside = min(16, self.nside // 2)
        with accel_device():
            vm = _sht.smoothing_grid(
                map_variance(vm, var_nside) ** 0.5, sigma=np.radians(2.0)
            )
        # guard against degenerate variance/base maps (possible with the
        # synthetic skydata stand-ins at low nside): 0/0 here would seed
        # NaNs through the whole cube
        mv = max(vm.mean(), 1e-30)

        fgt = (am / mv) * (fg - fgs)

        fgsmooth = haslam[np.newaxis, :] * ((efreq / 408.0)[:, np.newaxis] ** sc)

        fgt = np.where(
            np.abs(fgsmooth) > 0, fgt / np.where(fgsmooth == 0, 1.0, fgsmooth), 0.0
        )
        fgt = np.where(fgt < 0, np.tanh(fgt), fgt)
        fgt += 1
        fgt *= fgsmooth
        fgt = fgt[2:]

        if celestial:
            fgt = hputil.coord_g2c(fgt)

        if debug:
            return fgt, fg, fgs, fgsmooth, am, mv
        return fgt

    @on_model_device
    def _sigma_phi(self):
        """Faraday-depth window widths: |RM| smoothed with a 10° beam.

        Runs the smoothing transform pair on the accelerator in
        ring-grid layout instead of host f64 transforms; f32 is ample for
        a window-width map.
        Cached per (skydata, nside): the input is fixed survey data.
        """
        cached = getattr(self, "_sigma_phi_cache", None)
        if cached is not None and cached[0] == self.nside:
            return cached[1]

        def _build():
            from ..util.compute import accel_device

            with accel_device():
                sm = _sht.smoothing_grid(
                    np.abs(np.asarray(self._faraday)), fwhm=np.radians(10.0)
                )
            return hpx.ud_grade(sm.astype(np.float64), self.nside)

        out = _derived_cache(
            "sigmaphi", self._faraday, _build, extra=f"_{self.nside}"
        )
        self._sigma_phi_cache = (self.nside, out)
        return out

    def getpolsky(self, debug=False, celestial=True, key=None):
        """Realisation of the *polarised* sky [freq, pol, pixel] (K).

        Faraday-screen model (reference galaxy.py:209-344): random emission
        in the Faraday-conjugate coordinate, Gaussian φ correlation, a
        per-pixel Faraday-depth window, the φ→frequency transfer matrix,
        tanh saturation, and modulation by the Stokes-I realisation.
        """
        key = self._key(key)
        kI, kP = jax.random.split(key)

        sigma_phi = self._sigma_phi()

        xiphi = 1.0
        lmax = 3 * self.nside - 1
        la = np.arange(lmax + 1, dtype=np.float64)

        def angular(l):
            safe = np.where(l == 0, 1.0e16, l)
            return (safe / 100.0) ** -2.8

        dphi = self._dphi
        maxphi = self._maxphi
        nphi = 2 * int(maxphi / dphi)
        phifreq = np.fft.fftfreq(nphi, d=(1.0 / (dphi * nphi)))

        npix = 12 * self.nside**2

        # --- the whole Faraday screen runs ON DEVICE in ring-grid layout.
        # The reference loops nphi=1000 inverse complex SHTs through healpy
        # and then does the φ-window and the [npix, nphi]·[nphi, nfreq]
        # transfer matmul in host numpy (galaxy.py:260-313) — ~1e11 complex
        # flops single-core, the dominant cost of its polarised sky.  Here:
        # batched draw + complex synthesis (blocked over φ slices), the
        # φ-conjugate correlation, the matmul-DFT back into φ (fftmm), the
        # per-pixel
        # Faraday-depth window, the φ→ν transfer einsum and the tanh
        # saturation are one device pipeline; only the final [nfreq, Q/U]
        # grids come back to host for the pixel reorder.
        ps_weight = (angular(la) / 2.0) ** 0.5

        pcfreq = np.fft.fftfreq(nphi, d=dphi)
        corr_w = np.exp(-2 * (np.pi * xiphi * pcfreq) ** 2)

        # sigma_phi and the output live on the dense ring grid; pad cells
        # (j >= ring length) get sigma 1 and are dropped at pixel reorder
        info = hpx.ring_info(self.nside)
        nring = info["nphi"].size
        W = int(info["nphi"].max())
        r_of = np.repeat(np.arange(nring), info["nphi"])
        j_of = np.arange(npix) - info["start"][r_of]
        sig_grid = np.ones((nring, W), dtype=np.float32)
        sig_grid[r_of, j_of] = sigma_phi

        # phi -> frequency transfer matrix
        def ptrans(phi, freq, dfreq):
            dx = dfreq / freq
            alpha = 2.0 * phi * 3e2**2 / freq**2
            return np.exp(1.0j * alpha) * np.sinc(alpha * dx / np.pi)

        fa = self.nu_pixels
        df = np.median(np.diff(fa))
        pta = ptrans(phifreq[:, np.newaxis], fa[np.newaxis, :], df) / dphi

        from .. import native
        from ..util import xfer
        from ..util.compute import accel_device

        # escape the model_device (CPU) region: the screen pipeline runs
        # in f32 on the accelerator and is where all the flops are
        with accel_device():
            op = _sht.get_sht(self.nside, lmax)
            t = op.tables(False)
            qu_re, qu_im = _faraday_screen_device(
                op, t, kP, ps_weight, nphi, corr_w, sig_grid, phifreq, pta
            )
            qu_re = np.asarray(xfer.get(qu_re))
            qu_im = np.asarray(xfer.get(qu_im))

        start64 = info["start"].astype(np.int64)
        nphi64 = info["nphi"].astype(np.int64)
        map4_re = native.grid_to_pixels(qu_re, start64, nphi64, npix)
        map4_im = native.grid_to_pixels(qu_im, start64, nphi64, npix)

        map5 = np.zeros((self.nu_num, 4, npix), dtype=np.float64)
        map5[:, 0] = self.getsky(celestial=False, key=kI)
        map5[:, 1] = map4_re
        map5[:, 2] = map4_im
        map5[:, 1:3] *= map5[:, 0, np.newaxis, :]
        del map4_re, map4_im

        if celestial:
            map5 = hputil.coord_g2c(map5)
        return map5
