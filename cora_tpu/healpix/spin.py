"""Spin-weighted spherical harmonic transforms (spin-2 for polarisation).

Replaces healpy's polarised ``map2alm``/``alm2map`` (used by the reference
via hputil.sphtrans_real_pol / sphtrans_inv_real_pol, hputil.py:274-432).

Convention (CMB standard, as used by healpy):

.. math::
    (Q + iU)(\\hat n) = -\\sum_{lm} (E_{lm} + i B_{lm})\\; {}_{2}Y_{lm}
    (Q - iU)(\\hat n) = -\\sum_{lm} (E_{lm} - i B_{lm})\\; {}_{-2}Y_{lm}

The spin-weighted harmonics are evaluated through Wigner-d functions,

.. math:: {}_{s}Y_{lm}(\\theta,\\phi) = (-1)^m \\sqrt{(2l+1)/4\\pi}\\;
          d^{l}_{-m,s}(\\theta)\\, e^{im\\phi},

generated by the standard stable three-term recurrence in l (the same
chunked-scan + einsum structure as the scalar engine in sht.py).  Seeds and
signs are validated against closed-form ₂Y_2m expressions in the tests.
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from . import pixel
from .sht import (
    get_sht, _ck_override, _host_scaled_rows, _lam_scale_params,
)


def _wigner_d_recurrence_tables(lmax, m_arr, sp):
    """Coefficient tables for the d^l_{m, sp} recurrence over l.

    d^l = inv_l * [ (2l-1)(c - w2_l) d^{l-1} - v_{l-1} d^{l-2} ]
    with u_l = sqrt((l²-m²)(l²-sp²))/l, w2_l = m·sp/(l(l-1)), v_l = u_l.

    Returns (A[l, m], Bshift[l, m], C[l, m]) such that
    d^l = A (c - Bshift) d^{l-1} + C d^{l-2}, valid for l > l0 = max(|m|,|sp|).
    """
    L = lmax + 1
    l = np.arange(L)[:, None].astype(np.float64)
    m = m_arr[None, :].astype(np.float64)
    sp = float(sp)

    with np.errstate(divide="ignore", invalid="ignore"):
        u_l = np.sqrt((l**2 - m**2) * (l**2 - sp**2)) / l
        u_lm1 = np.sqrt(((l - 1) ** 2 - m**2) * ((l - 1) ** 2 - sp**2)) / (l - 1)
        A = (2 * l - 1) / u_l
        Bshift = m * sp / (l * (l - 1))
        C = -u_lm1 / u_l

    l0 = np.maximum(np.abs(m), abs(sp))
    valid = l > l0
    A = np.where(valid, A, 0.0)
    Bshift = np.where(valid, np.nan_to_num(Bshift), 0.0)
    C = np.where(valid, np.nan_to_num(C), 0.0)
    return A, Bshift, C


def _wigner_d_seed_log(theta, m_arr, sp):
    """Seed values d^{l0}_{m, sp}(theta) at l0 = max(|m|, |sp|) per m, as
    (ln|d|, sign(d)).

    Closed forms (Varshalovich):
      d^j_{j, m'}  = sqrt(C(2j, j-m')) cos^{j+m'}(θ/2) (-sin(θ/2))^{j-m'}
      d^j_{-j, m'} = sqrt(C(2j, j-m')) cos^{j-m'}(θ/2) sin^{j+m'}(θ/2)
      d^j_{m, j}   = sqrt(C(2j, j-m)) cos^{j+m}(θ/2) sin^{j-m}(θ/2)
      d^j_{m, -j}  = sqrt(C(2j, j+m)) cos^{j-m}(θ/2) (-sin(θ/2))^{j+m}
    evaluated in log space: near the poles the seeds fall far below the
    smallest float (even f64 at high m), although the recurrence grows
    them back to O(1) within the band.  Here m ranges over m_arr (can be
    negative) and sp is fixed.
    """
    from scipy.special import gammaln

    theta = np.asarray(theta, dtype=np.float64)[:, None]
    lnc = np.log(np.maximum(np.cos(theta / 2), 1e-300))
    lns = np.log(np.maximum(np.sin(theta / 2), 1e-300))

    m = m_arr[None, :].astype(np.float64)
    sp = float(sp)
    j = np.maximum(np.abs(m), abs(sp))

    def logbinom(n, k):
        return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)

    def odd(x):
        return np.where(x % 2 == 1, -1.0, 1.0)

    # Case |m| >= |sp|
    lb = 0.5 * logbinom(2 * j, j - sp)
    mask = np.abs(m) >= abs(sp)
    # m >= 0 corner: d^j_{j, sp} = sqrt(C(2j, j-sp)) c^{j+sp} (-s)^{j-sp}
    ln_p, sg_p = lb + (j + sp) * lnc + (j - sp) * lns, odd(j - sp)
    # m < 0 corner: d^j_{-j, sp} = sqrt(C(2j, j+sp)) c^{j-sp} s^{j+sp}
    ln_n, sg_n = lb + (j - sp) * lnc + (j + sp) * lns, 1.0
    # Case |sp| > |m|
    if sp >= 0:  # d^sp_{m, sp}
        ln_2 = 0.5 * logbinom(2 * j, j - m) + (j + m) * lnc + (j - m) * lns
        sg_2 = 1.0
    else:  # d^{|sp|}_{m, -|sp|}
        ln_2 = 0.5 * logbinom(2 * j, j + m) + (j - m) * lnc + (j + m) * lns
        sg_2 = odd(j + m)
    shape = (theta.size, m_arr.size)
    ln = np.where(mask, np.where(m >= 0, ln_p, ln_n), ln_2)
    sign = np.where(mask, np.where(m >= 0, sg_p, sg_n), sg_2)
    return np.broadcast_to(ln, shape), np.broadcast_to(sign, shape)


class SpinSHT:
    """Spin-s transform operator built on the scalar SHT infrastructure.

    Computes ring-spectra G±[r, m] = Σ_l (E ∓? ...) using the two
    spin-weighted Legendre families ₛλ_lm and ₋ₛλ_lm, then reuses the
    scalar engine's Bluestein ring-FFT stage for the complex maps Q ± iU.
    """

    def __init__(self, nside, lmax, spin=2, l_chunk=64,
                 legendre_mode="scan", lambda_cache=None):
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.spin = int(spin)
        self.scalar = get_sht(nside, lmax, l_chunk)
        self.l_chunk = self.scalar.l_chunk
        self.legendre_mode = legendre_mode

        L = lmax + 1
        info = pixel.ring_info(nside)
        nh = 2 * nside
        theta_h = info["theta"][:nh]

        # lambda^{±s}_{lm}(θ) = (-1)^m sqrt((2l+1)/4π) d^l_{-m, ±s}(θ)
        # recurrence tables for (M = -m, sp = ±s) over m >= 0
        m_arr = -np.arange(L)  # M = -m
        self._tab = {}
        for sp in (self.spin, -self.spin):
            A, B, C = _wigner_d_recurrence_tables(lmax, m_arr, sp)
            ln_seed, seed_sign = _wigner_d_seed_log(theta_h, m_arr, sp)
            l0 = np.maximum(np.arange(L), abs(sp))
            self._tab[sp] = (A, B, C, ln_seed, seed_sign, l0)
        self._norm_sign = np.where(np.arange(L) % 2 == 0, 1.0, -1.0)  # (-1)^m
        self._z_half = np.cos(theta_h)

        # cached mode: host f64 recurrence → f32 ₛλ chunk tensors (both
        # spin families, northern rings), contracted by einsums like the
        # scalar engine.  Table memory is 2·nh·L²/2·4 B (no ℓ-parity
        # decoupling for spin-weighted functions) — intended for
        # nside ≤ 256; use "scan" beyond that.
        self._lam_spin = None
        if legendre_mode == "cached":
            self._lam_spin = self._load_or_build_spin_lambda(lambda_cache)
        self._dev_tables = {}

    def _load_or_build_spin_lambda(self, cache_path):
        """Both spin-family Λ chunk sets, disk-cached like the scalar
        engine's weights (pure function of nside/lmax/spin/l_chunk)."""
        import os

        meta = np.array(
            [self.nside, self.lmax, self.spin, self.l_chunk, 1],
            dtype=np.int64,
        )
        if cache_path and os.path.exists(cache_path):
            try:
                d = np.load(cache_path)
                if np.array_equal(d["meta"], meta):
                    n = int(d["n"])
                    return {
                        sp: [d[f"lam_{sp}_{i}"] for i in range(n)]
                        for sp in (self.spin, -self.spin)
                    }
            except Exception:
                pass
        lam = {
            sp: self._build_spin_lambda(sp)
            for sp in (self.spin, -self.spin)
        }
        if cache_path:
            try:
                arrs = {
                    f"lam_{sp}_{i}": c
                    for sp, chunks in lam.items()
                    for i, c in enumerate(chunks)
                }
                np.savez(cache_path, meta=meta,
                         n=len(lam[self.spin]), **arrs)
            except Exception:
                pass
        return lam

    def tables(self, double: bool = False):
        """Device table pytree: scalar engine tables, plus the spin Λ
        chunks (cached mode) or the scaled recurrence tables (scan mode).

        Passed to the jitted transforms as ARGUMENTS, so the programs do
        not embed [L, L]-sized constants.
        """
        key = (bool(double), str(jax.config.jax_default_device))
        if key not in self._dev_tables:
            t = {"sc": self.scalar.tables(double)}
            if self._lam_spin is not None:
                # device layout [mw, nrows, nh] (m-major) — matches the
                # contraction operand layout, avoiding per-call Λ-sized
                # layout copies (see sht.SHT._make_tables)
                t["sp"] = {
                    str(sp): tuple(
                        jax.device_put(
                            np.ascontiguousarray(c.transpose(2, 0, 1))
                        )
                        for c in chunks
                    )
                    for sp, chunks in self._lam_spin.items()
                }
            else:
                fdt = np.float64 if double else np.float32
                t["rec"] = {
                    str(sp): tuple(
                        jax.device_put(a) for a in self._rec_tables(sp, fdt)
                    )
                    for sp in (self.spin, -self.spin)
                }
            self._dev_tables[key] = t
        return self._dev_tables[key]

    def _rec_tables(self, sp, fdt):
        """Scan-mode recurrence tables of one spin family at dtype ``fdt``:
        (A, B, C) padded to whole ℓ-chunks, the seeds pre-scaled into
        [2^-β, 2^β) with their scale counts k0 (libsharp-style, as
        sht._scaled_lam_step), l0, z and the (−1)^m·√((2ℓ+1)/4π) norms."""
        A, B, C, ln_seed, seed_sign, l0 = self._tab[sp]
        L = self.lmax + 1
        Lp = -(-L // self.l_chunk) * self.l_chunk
        pad = ((0, Lp - L), (0, 0))
        S, beta = _lam_scale_params(fdt)
        log2_seed = ln_seed / np.log(2.0)
        k0 = np.ceil(np.maximum(0.0, -(log2_seed + beta) / S))
        with np.errstate(under="ignore"):
            seed = seed_sign * np.exp2(log2_seed + S * k0)
        norm = np.sqrt((2 * np.arange(Lp) + 1) / (4 * np.pi))
        rec = tuple(
            np.asarray(x, fdt) for x in (
                np.pad(A, pad), np.pad(B, pad), np.pad(C, pad), seed, k0,
                l0, self._z_half, norm, self._norm_sign,
            )
        )
        # f32 only: overriding the f64 recurrence with f32-cast rows
        # would degrade it
        if np.dtype(fdt) == np.dtype(np.float32):
            rec += (self._host_checkpoints(sp),)
        return rec

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def _host_rows(self, sp):
        """Exact f64 host recurrence (scaled, sht._host_scaled_rows):
        yields (l, lam, k) with true row where(k == 0, lam, 0) of
        d^l_{-m,sp}(θ) [nh, L]."""
        A, B, C, ln_seed, seed_sign, l0 = self._tab[sp]
        z = self._z_half[:, None]

        def step(l, sl, lam_p, out):
            out[:, sl] *= C[l, sl]
            out[:, sl] += A[l, sl] * (z - B[l, sl]) * lam_p[:, sl]

        return _host_scaled_rows(ln_seed / np.log(2.0), seed_sign, l0, step)

    def _build_spin_lambda(self, sp):
        """Host recurrence → list of f32 chunks [lc, nh, mw] with the
        (−1)^m·norm factors baked in (matching the scan path's lam_n)."""
        L = self.lmax + 1
        nh = 2 * self.nside
        lc = self.l_chunk
        norm = np.sqrt((2 * np.arange(L) + 1) / (4 * np.pi))
        chunks = []
        for l, lam, k in self._host_rows(sp):
            i = l % lc
            if i == 0:
                mw = min(L, ((min(L, l + lc) + 127) // 128) * 128)
                buf = np.zeros((lc, nh, mw), dtype=np.float32)
                chunks.append(buf)
            buf[i] = (np.where(k[:, :mw] == 0, lam[:, :mw], 0.0)
                      * norm[l] * self._norm_sign[:mw])
        return chunks

    def _host_checkpoints(self, sp):
        """f32 copies of the exact carry rows (d^{l0-2}, d^{l0-1}) at every
        ℓ-chunk start l0, [nchunk, 2, nh, L].

        Re-seeding the f32 scan from them at each chunk bounds its
        rounding growth to one chunk, as the scalar engine's scan_ckpt
        does: the three-term recurrence loses ~ε·ℓ^1.5 of relative
        accuracy near the poles, above the 1e-5 map contract at
        nside 512 if it runs unbroken over the whole ℓ range.
        """
        L = self.lmax + 1
        lc = self.l_chunk
        nchunk = -(-L // lc)
        ck = np.zeros((nchunk, 2, 2 * self.nside, L), np.float32)
        for l, lam, k in self._host_rows(sp):
            c, i = divmod(l + 2, lc)
            if i < 2 and 0 < c < nchunk:
                ck[c, i] = np.where(k == 0, lam, 0.0)
        return ck

    def _lam_chunks(self, rec, fold, carry0, xs=()):
        """Scan the scaled Wigner-d recurrence over ℓ-chunks.

        ``fold(carry, x, lam_n) -> (carry, y)`` receives each normalised
        ₛλ chunk [l_chunk, nh, L] = (−1)^m √((2ℓ+1)/4π) d^ℓ_{−m,sp}(θ)
        with the chunk's slice ``x`` of ``xs``.  The recurrence carries
        λ̃ = λ·2^{S·k} with a per-(ring, m) scale count k (seeds below
        the float range otherwise flush to zero near the poles and lose
        the modes they grow into); entries still scaled emit zero.  In f32
        the carry restarts from exact rows at each chunk start
        (:meth:`_host_checkpoints`).
        """
        A, B, C, seed, k0, l0, z, norm, sign = rec[:9]
        ck = rec[9] if len(rec) > 9 else None
        S, beta = _lam_scale_params(seed.dtype)
        thresh = jnp.asarray(2.0**beta, seed.dtype)
        down = jnp.asarray(2.0**-S, seed.dtype)
        lc = self.l_chunk
        nchunk = A.shape[0] // lc
        L = self.lmax + 1
        zc = z[:, None]

        def l_step(c, ys):
            lam_p, lam_pp, k, l = c
            A_l, B_l, C_l = ys
            lam = A_l * (zc - B_l) * lam_p + C_l * lam_pp
            at_seed = l == l0
            lam = jnp.where(at_seed, seed, lam)
            k = jnp.where(at_seed, k0, k)
            out = jnp.where(k == 0, lam, 0.0)
            grow = (jnp.abs(lam) > thresh) & (k > 0)
            return (
                jnp.where(grow, lam * down, lam),
                jnp.where(grow, lam_p * down, lam_p),
                jnp.where(grow, k - 1, k),
                l + 1,
            ), out

        def chunk_step(carry, xs_c):
            (lam_p, lam_pp, k, l), inner = carry
            x, Aa, Bb, Cc = xs_c[:4]
            if ck is not None:
                lam_p, lam_pp, k = _ck_override(xs_c[4], lam_p, lam_pp, k)
            (lam_p, lam_pp, k, lN), lam_chunk = jax.lax.scan(
                l_step, (lam_p, lam_pp, k, l), (Aa, Bb, Cc)
            )
            lidx = l + jnp.arange(lc)
            lam_n = lam_chunk * norm[lidx][:, None, None] * sign
            inner, y = fold(inner, x, lam_n)
            return ((lam_p, lam_pp, k, lN), inner), y

        lam0 = jnp.zeros((z.shape[0], L), seed.dtype)
        rec0 = (lam0, lam0, jnp.zeros_like(lam0), jnp.asarray(0))

        def chunks(x):
            return x.reshape((nchunk, lc) + x.shape[1:])

        (_, carry), ys = jax.lax.scan(
            chunk_step, (rec0, carry0),
            (xs, chunks(A), chunks(B), chunks(C))
            + (() if ck is None else (ck,)),
        )
        return carry, ys

    def _contract(self, t, alm, sp):
        """G[..., nh(r), m] = Σ_l alm[..., l, m] · ₛλ_lm(θ_r), northern rings.

        ₛλ_lm = (-1)^m sqrt((2l+1)/4π) d^l_{-m, sp}(θ).
        """
        if self._lam_spin is not None:
            return self._contract_cached(t, alm, sp)
        L = self.lmax + 1
        nh = 2 * self.nside
        lc = self.l_chunk
        Lp = -(-L // lc) * lc
        if Lp != L:
            alm = jnp.pad(alm, [(0, 0)] * (alm.ndim - 2) + [(0, Lp - L), (0, 0)])
        alm_c = jnp.moveaxis(alm, -2, 0)
        alm_c = alm_c.reshape((Lp // lc, lc) + alm_c.shape[1:])

        def fold(G, alm_x, lam_n):
            lam_n = lam_n.astype(alm_x.real.dtype)
            return G + jnp.einsum("lrm,l...m->...rm", lam_n, alm_x,
                                  precision=self.scalar.precision), None

        G0 = jnp.zeros(alm.shape[:-2] + (nh, L), dtype=alm.dtype)
        G, _ = self._lam_chunks(t["rec"][str(sp)], fold, G0, alm_c)
        return G

    def _contract_cached(self, t, alm, sp):
        """Cached-Λ spin contraction (einsums over f32 chunk tables)."""
        L = self.lmax + 1
        nh = 2 * self.nside
        lc = self.l_chunk
        batch_shape = alm.shape[:-2]
        G = jnp.zeros(batch_shape + (nh, L), dtype=alm.dtype)
        for c, lam_c in enumerate(t["sp"][str(sp)]):
            l_lo = c * lc
            l_hi = min(L, l_lo + lc)
            mw = min(lam_c.shape[0], L)
            lam = lam_c[:mw, : l_hi - l_lo, :].astype(alm.real.dtype)
            ablk = alm[..., l_lo:l_hi, :mw]
            X = jnp.einsum("mlr,...lm->...rm", lam, ablk,
                           precision=self.scalar.precision)
            G = G.at[..., :mw].add(X)
        return G

    def _project_cached(self, t, G, sp):
        """Adjoint of the cached contraction."""
        L = self.lmax + 1
        lc = self.l_chunk
        parts = []
        for c, lam_c in enumerate(t["sp"][str(sp)]):
            l_lo = c * lc
            l_hi = min(L, l_lo + lc)
            mw = min(lam_c.shape[0], L)
            lam = lam_c[:mw, : l_hi - l_lo, :].astype(G.real.dtype)
            out = jnp.einsum("mlr,...rm->...lm", lam, G[..., :mw],
                             precision=self.scalar.precision)
            if L - mw:
                out = jnp.pad(
                    out, [(0, 0)] * (out.ndim - 2) + [(0, 0), (0, L - mw)]
                )
            parts.append(out)
        return jnp.concatenate(parts, axis=-2)[..., :L, :]

    def _project(self, t, G, sp):
        """Adjoint of _contract: alm[..., l, m] = Σ_{r<nh} ₛλ_lm(θ_r) G[..., r, m]."""
        if self._lam_spin is not None:
            return self._project_cached(t, G, sp)
        L = self.lmax + 1

        def fold(carry, _, lam_n):
            lam_n = lam_n.astype(G.real.dtype)
            return carry, jnp.einsum("lrm,...rm->...lm", lam_n, G,
                                     precision=self.scalar.precision)

        _, alm_chunks = self._lam_chunks(t["rec"][str(sp)], fold, ())
        alm = jnp.moveaxis(alm_chunks, 0, -3)
        return alm.reshape(alm.shape[:-3] + (-1, L))[..., :L, :]

    def _contract_full_rings(self, t, alm, sp):
        """Ring spectra over ALL rings for the ₛλ family, using
        ₛλ_lm(π−θ) = (−1)^{l+m} ₋ₛλ_lm(θ)."""
        nring = self.scalar.nring
        nh = 2 * self.nside

        L = self.lmax + 1
        lidx = jnp.arange(L)[:, None]
        midx = jnp.arange(L)[None, :]
        par = ((lidx + midx) % 2 == 0).astype(alm.real.dtype)

        G_n = self._contract(t, alm, sp)  # northern rings, ₛλ family
        # southern: (−1)^{l+m} with the OPPOSITE spin family
        alm_flip = alm * (2 * par - 1)
        G_s = self._contract(t, alm_flip, -sp)

        mirror = jnp.asarray(self.scalar._mirror)
        north = jnp.arange(nring) < nh
        G = jnp.where(
            north[:, None],
            G_n[..., jnp.minimum(jnp.arange(nring), nh - 1), :],
            G_s[..., mirror, :],
        )
        return G

    def synthesis(self, alm_E, alm_B):
        """(E, B) alms → (Q, U) maps."""
        t = self.tables(alm_E.dtype == jnp.complex128)
        return _spin_synthesis(self, t, alm_E, alm_B)

    def _synthesis_impl(self, t, alm_E, alm_B):
        s = self.spin
        # a⁺ = -(E + iB), a⁻ = -(E - iB)
        ap = -(alm_E + 1j * alm_B)
        am = -(alm_E - 1j * alm_B)

        # (Q+iU)(n) = Σ_{lm} ap_lm ₛY_lm.  With the real-field symmetry of
        # E/B (a_{l,-m} = (-1)^m a*_{lm}) and ₛY_{l,-m} = (-1)^s conj(₋ₛY_lm)
        # the negative-m part folds onto the opposite-spin family:
        #   Q+iU = Σ_{m>=0} ap ₛY + (-1)^s conj( Σ_{m>0} am ₋ₛY ).
        # Convention: ₛY_lm = (-1)^m sqrt((2l+1)/4π) d^l_{-m,-s} e^{imφ},
        # so the ₛλ family is the sp = -s Wigner table.
        Gp = self._contract_full_rings(t, ap, -s)
        Gm = self._contract_full_rings(t, am, s)

        sc = self.scalar
        from .sht import _rings_to_complex as _r2c

        Sp = _r2c(sc, t["sc"], Gp)  # Σ_{m>=0} Gp e^{imφ}
        Sm = _r2c(sc, t["sc"], Gm)

        sgn = (-1.0) ** s
        # exclude m=0 from the second (m>0) sum
        P = Sp + sgn * (jnp.conj(Sm) - jnp.conj(Gm[..., sc._r_of_pix, 0]))
        return P.real, P.imag

    def analysis(self, Q, U, iter: int = 3):
        """(Q, U) maps → (E, B) alms (quadrature + Jacobi refinement)."""
        t = self.tables(Q.dtype == jnp.float64)
        return _spin_analysis(self, t, Q, U, iter)

    def _analysis_impl(self, t, Q, U, iter):
        E, B = self._analysis_once(t, Q, U)
        for _ in range(iter):
            Qs, Us = self._synthesis_impl(t, E, B)
            dE, dB = self._analysis_once(t, Q - Qs, U - Us)
            E = E + dE
            B = B + dB
        return E, B

    def _analysis_once(self, t, Q, U):
        s = self.spin
        sc = self.scalar
        w = 4.0 * np.pi / sc.npix
        P = (Q + 1j * U).astype(jnp.complex128 if Q.dtype == jnp.float64 else jnp.complex64)

        # G⁺_rm = Σ_j P(φ_j) e^{-imφ_j};  G⁻_rm = Σ_j P*(φ_j) e^{-imφ_j}
        from .sht import _map_to_rings as _m2r

        Gp = _m2r(sc, t["sc"], P, P.dtype)
        Gm = _m2r(sc, t["sc"], jnp.conj(P), P.dtype)

        # ap_lm = w Σ_r ₛλ G⁺;  am_lm = w Σ_r ₋ₛλ G⁻  (ₛλ ↔ sp=-s table),
        # with the southern-ring parity fold as in the scalar projection.
        ap = self._project_full(t, Gp * w, -s)
        am = self._project_full(t, Gm * w, s)

        E = -(ap + am) / 2.0
        B = -(ap - am) / (2.0j)
        return E, B

    def synthesis_grid(self, alm_E, alm_B):
        """(E, B) alms → (Q, U) on the dense ring grid (device-safe layout:
        no pixel gather; use scalar.grid_to_map / the native converter for
        HEALPix ordering)."""
        t = self.tables(alm_E.dtype == jnp.complex128)
        return _spin_synthesis_grid(self, t, alm_E, alm_B)

    def _synthesis_grid_impl(self, t, alm_E, alm_B):
        from .sht import _rings_to_grid_complex

        s = self.spin
        ap = -(alm_E + 1j * alm_B)
        am = -(alm_E - 1j * alm_B)
        Gp = self._contract_full_rings(t, ap, -s)
        Gm = self._contract_full_rings(t, am, s)

        Sp = _rings_to_grid_complex(self.scalar, t["sc"], Gp)
        Sm = _rings_to_grid_complex(self.scalar, t["sc"], Gm)

        valid = (t["sc"]["bl_C"] != 0.0)
        sgn = (-1.0) ** s
        P = Sp + sgn * (jnp.conj(Sm) - jnp.conj(Gm[..., :, 0:1]) * valid)
        return P.real, P.imag


    def analysis_grid(self, Qg, Ug, iter: int = 3):
        """(Q, U) on the dense ring grid → (E, B) alms (device-safe)."""
        t = self.tables(Qg.dtype == jnp.float64)
        return _spin_analysis_grid(self, t, Qg, Ug, iter)

    def _analysis_grid_impl(self, t, Qg, Ug, iter):
        E, B = self._analysis_once_grid(t, Qg, Ug)
        for _ in range(iter):
            Qs, Us = self._synthesis_grid_impl(t, E, B)
            dE, dB = self._analysis_once_grid(t, Qg - Qs, Ug - Us)
            E = E + dE
            B = B + dB
        return E, B

    def _analysis_once_grid(self, t, Qg, Ug):
        from .sht import _grid_to_rings

        s = self.spin
        sc = self.scalar
        w = 4.0 * np.pi / sc.npix
        cdtype = (
            jnp.complex128 if Qg.dtype == jnp.float64 else jnp.complex64
        )
        P = (Qg + 1j * Ug).astype(cdtype)

        Gp = _grid_to_rings(sc, t["sc"], P, cdtype)
        Gm = _grid_to_rings(sc, t["sc"], jnp.conj(P), cdtype)

        ap = self._project_full(t, Gp * w, -s)
        am = self._project_full(t, Gm * w, s)

        E = -(ap + am) / 2.0
        B = -(ap - am) / (2.0j)
        return E, B

    def _project_full(self, t, G, sp):
        """Adjoint over all rings using the ± family parity relation."""
        nh = 2 * self.nside
        mirror = jnp.asarray(self.scalar._mirror)
        south_idx = mirror[nh:]

        G_n = G[..., :nh, :]
        G_s = G[..., nh:, :]

        # northern contribution with ₛλ
        Gn_half = G_n
        # southern rings contribute via ₛλ(π−θ) = (−1)^{l+m} ₋ₛλ(θ)
        Gs_half = jnp.zeros_like(G_n)
        Gs_half = Gs_half.at[..., south_idx, :].add(G_s)

        alm_n = self._project(t, Gn_half, sp)
        alm_s = self._project(t, Gs_half, -sp)

        L = self.lmax + 1
        lidx = jnp.arange(L)[:, None]
        midx = jnp.arange(L)[None, :]
        par = jnp.where((lidx + midx) % 2 == 0, 1.0, -1.0)
        return alm_n + alm_s * par


@partial(jax.jit, static_argnums=0)
def _spin_synthesis(op, t, alm_E, alm_B):
    return op._synthesis_impl(t, alm_E, alm_B)


@partial(jax.jit, static_argnums=0)
def _spin_synthesis_grid(op, t, alm_E, alm_B):
    return op._synthesis_grid_impl(t, alm_E, alm_B)


@partial(jax.jit, static_argnums=(0, 4))
def _spin_analysis_grid(op, t, Qg, Ug, iter):
    return op._analysis_grid_impl(t, Qg, Ug, iter)


@partial(jax.jit, static_argnums=(0, 4))
def _spin_analysis(op, t, Q, U, iter):
    return op._analysis_impl(t, Q, U, iter)


@lru_cache(maxsize=4)
def get_spin_sht(nside: int, lmax: int, spin: int = 2,
                 legendre_mode: str = "scan") -> SpinSHT:
    return SpinSHT(nside, lmax, spin, legendre_mode=legendre_mode)


def alm2map_spin(alm_E, alm_B, spin, nside):
    """Synthesize (Q, U) maps from (E, B) alms (healpy.alm2map_spin-like)."""
    lmax = alm_E.shape[-2] - 1
    op = get_spin_sht(nside, lmax, spin)
    return op.synthesis(jnp.asarray(alm_E), jnp.asarray(alm_B))


def map2alm_spin(Q, U, spin, lmax, iter=3):
    """Analyse (Q, U) maps into (E, B) alms."""
    nside = pixel.npix2nside(np.asarray(Q).shape[-1])
    op = get_spin_sht(nside, lmax, spin)
    return op.analysis(jnp.asarray(Q), jnp.asarray(U), iter)  # real inputs
