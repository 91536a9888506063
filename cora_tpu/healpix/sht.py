"""Native spherical harmonic transforms on HEALPix grids.

This module is the JAX replacement for the reference's biggest
native dependency — healpy/libsharp's ``map2alm``/``alm2map`` (reference
cora/util/hputil.py:195-531).  The design follows SURVEY.md §7:

* **Legendre stage**: normalised associated Legendre functions
  :math:`\\lambda_{\\ell m}(\\theta)` are either generated in-graph by the
  stable three-term recurrence (float64, "scan" mode — exact, used for CPU
  tests) or precomputed host-side into float32 l-chunk tensors ("cached"
  mode — the accelerator production path: the transform becomes a
  sequence of einsums against resident Λ "weights", with no f64 on
  device).
* **Ring symmetry**: λ(π−θ) = (−1)^{l+m} λ(θ): only the 2·nside northern
  rings are computed; even/odd (l+m) contractions give the south for free.
* **Ring FFT stage**: each ring is a uniform azimuthal grid with a phase
  offset; m-modes alias into the ring spectrum.  All rings are evaluated
  with one batched Bluestein (chirp-z) transform at a single static padded
  FFT size — static shapes, no per-ring Python loops.
* **Analysis** uses pixel-area quadrature plus Jacobi refinement
  iterations (default 3), matching healpy's ``map2alm(iter=...)`` accuracy
  contract without shipped ring-weight tables.

All large tables are passed to the jitted programs as *arguments* (device
buffers), never as closure constants — keeping HLO small and compile times
flat.  The a_lm layout is the dense 2D ``alm[..., l, m]`` (m ≥ 0) used
throughout the reference (hputil.unpack_alm).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from . import pixel
from ..ops import fftmm
from ..util.profiling import stage as _stage
from ..util.xfer import put as _put


def _next_fft_size(n):
    """Smallest power of two ≥ n."""
    s = 1
    while s < n:
        s *= 2
    return s


def _next_conv_size(n):
    """Smallest 3-smooth size (2^a or 3·2^a) ≥ n.

    The four-step matmul DFT works for any composite length (the stage
    DFTs are dense matmuls), so banded cap convolutions also use 3·2^a
    sizes — e.g. 3072 instead of 4096 for the 1536-point band."""
    p2 = _next_fft_size(n)
    p3 = 3 * _next_fft_size(max(1, -(-n // 3)))
    return min(p2, p3) if p3 >= n else p2


# ===========================================================================
# Jitted worker functions.  `op` is a static argument (hashable SHT config);
# `t` is the pytree of device tables.
# ===========================================================================


def _legendre_contract_cached(op, t, alm):
    """G[..., ring, m] = Σ_l alm[..., l, m] λ_lm(θ_ring), cached-Λ path.

    Λ chunks are parity-packed (pure even-ℓ / odd-ℓ): for fixed ℓ-parity,
    whether a term feeds the even (north+south) or odd (north−south)
    accumulator is a function of m alone, so the einsums run un-masked —
    half the FLOPs of masking alm by (ℓ+m) parity — and cheap m-parity
    masks route each chunk's output.
    """
    L = op.lmax + 1
    nh = op.nhalf

    # complex alm: run the contraction on split re/im f32 planes batched
    # on a leading axis — the einsums then have purely REAL operands (2
    # real matmuls each instead of a complex×real dot) — and join back to
    # complex at the end
    is_cplx = jnp.iscomplexobj(alm)
    if is_cplx:
        alm = jnp.stack([alm.real, alm.imag], axis=-3)

    # pack alm rows by ell parity: [evens; odds] — one cheap reorder
    ne = (L + 1) // 2
    alm_p = jnp.concatenate([alm[..., 0::2, :], alm[..., 1::2, :]], axis=-2)

    batch_shape = alm.shape[:-2]
    H0 = jnp.zeros(batch_shape + (nh, L), dtype=alm.dtype)
    H1 = jnp.zeros_like(H0)
    midx = jnp.arange(L)[None, :]

    for (parity, sub_lo, nrows, _), lam_c in zip(op._lam_meta, t["lam"]):
        mw = min(lam_c.shape[0], L)
        off = sub_lo + (0 if parity == 0 else ne)
        ablk = alm_p[..., off : off + nrows, :mw]
        lam = lam_c[:mw, :nrows, :].astype(alm.real.dtype)
        X = jnp.einsum("mlr,...lm->...rm", lam, ablk, precision=op.precision)
        if parity == 0:
            H0 = H0.at[..., :mw].add(X)
        else:
            H1 = H1.at[..., :mw].add(X)

    # m-parity masks applied once (see _legendre_contract_streamed)
    meven = (midx % 2 == 0).astype(alm.real.dtype)
    Ge = H0 * meven + H1 * (1.0 - meven)
    Go = H0 * (1.0 - meven) + H1 * meven

    Gn = Ge + Go
    Gs = Ge - Go
    if is_cplx:
        Gn = _join_planes(Gn)
        Gs = _join_planes(Gs)
    north = jnp.arange(op.nring) < nh
    return jnp.where(
        north[:, None], Gn[..., t["north_idx"], :], Gs[..., t["mirror"], :]
    )


def _legendre_contract_streamed(op, t, alm_block_fn, batch_shape, dtype,
                                expand=True):
    """Streaming variant of :func:`_legendre_contract_cached`.

    The alm rows for each parity-packed ℓ-chunk are produced on the fly by
    ``alm_block_fn(c, off, nrows, mw) -> [..., nrows, ≥min(mw, L)]`` (off
    indexes the parity-packed ell order: evens then odds; mw is the
    chunk's maximum m width — producers need not fill columns beyond it)
    so the full [..., L, L] alm array never materialises in device memory
    (at Nside=512 × 256 channels the alm cube alone is 4.8 GB and its
    draw temporaries triple that).
    """
    L = op.lmax + 1
    nh = op.nhalf
    ne = (L + 1) // 2
    midx = jnp.arange(L)[None, :]

    # per-ℓ-parity accumulators; the m-parity masks that route them into
    # the even/odd (north±south) combination apply ONCE at the end — the
    # chunk loop is pure matmul + in-place add (minimal liveness/traffic)
    H0 = jnp.zeros(batch_shape + (nh, L), dtype=dtype)
    H1 = jnp.zeros_like(H0)

    for c, ((parity, sub_lo, nrows, _), lam_c) in enumerate(
        zip(op._lam_meta, t["lam"])
    ):
        mw = min(lam_c.shape[0], L)
        off = sub_lo + (0 if parity == 0 else ne)
        alm_blk = alm_block_fn(c, off, nrows, mw)[..., :mw]
        lam = lam_c[:mw, :nrows, :].astype(alm_blk.real.dtype)
        # λ is structurally zero for m > l, killing the m > l noise terms.
        X = jnp.einsum("mlr,...lm->...rm", lam, alm_blk, precision=op.precision)
        if parity == 0:
            H0 = H0.at[..., :mw].add(X)
        else:
            H1 = H1.at[..., :mw].add(X)

    meven = (midx % 2 == 0).astype(jnp.float32)
    Ge = H0 * meven + H1 * (1.0 - meven)
    Go = H0 * (1.0 - meven) + H1 * meven

    if not expand:
        return Ge, Go
    return _expand_rings(op, t, Ge, Go)


def _legendre_contract_scan_streamed(op, t, alm_block_fn, batch_shape, dtype,
                                     expand=True):
    """Streaming contraction with in-graph (scaled, checkpointed) λ.

    The scan-mode twin of :func:`_legendre_contract_streamed`: no Λ table
    in device memory — λ rows are regenerated by the recurrence per consecutive-ℓ
    chunk, and ``alm_block_fn(c, l0, nrows, mw) -> [..., nrows, mw]``
    produces the matching alm rows on the fly.  This is the Legendre stage
    for Nside ≥ 1024 (the cached Λ table would be ~38 GB at Nside=1024;
    checkpoints are ~1/l_chunk of that).

    Rows split by ℓ parity feed the H0/H1 accumulators so the einsums run
    un-masked at half FLOPs, with m-parity routing deferred to the end
    (same scheme as the cached path).  l_chunk must be even.
    """
    L = op.lmax + 1
    # ring count from the tables, not the op: under 2-D (freq × ring-band)
    # sharding each device holds an nh-slice of z_half/lam_mm/lam_k0/lam_ck
    # and runs this same program on its own rings (parallel/mesh.py)
    nh = t["z_half"].shape[0]
    lc = op.l_chunk
    if lc % 2:
        raise ValueError("scan streaming requires even l_chunk")
    nchunk = -(-L // lc)
    m_arr = jnp.arange(L)
    midx = m_arr[None, :]
    z = t["z_half"]
    fdt = t["lam_mm"].dtype

    H0 = jnp.zeros(batch_shape + (nh, L), dtype=dtype)
    H1 = jnp.zeros_like(H0)

    lam_p = jnp.zeros((nh, L), dtype=fdt)
    lam_pp = jnp.zeros_like(lam_p)
    k = jnp.zeros_like(lam_p)
    ck_c = t.get("lam_ck")

    # chunks are processed in ckpt_every-sized BANDS: each band is one
    # lax.scan over its chunks, so the HLO scales with the number of
    # bands, not chunks (384 unrolled chunks at nside=2048 produced a
    # pathological compile).  Checkpoint overrides land exactly at band
    # starts, and for ckpt_every == 1 (bands of one chunk) the behaviour
    # — including RNG consumption — is identical to chunk-level code.
    g = op.ckpt_every
    nband = -(-nchunk // g)

    for b in range(nband):
        c_lo = b * g
        nc = min(g, nchunk - c_lo)
        l_lo = c_lo * lc
        mw = min(L, ((min(L, (c_lo + nc) * lc) + 127) // 128) * 128)
        if ck_c is not None:
            lam_p, lam_pp, k = _ck_override(ck_c[b], lam_p, lam_pp, k)

        l_step = _scaled_lam_step(t["lam_mm"], t["lam_k0"], z, m_arr,
                                  out_mw=mw)
        # rec rows for the band, padded to nc·lc (zero rows emit zero λ)
        nr = min(L - l_lo, nc * lc)
        aa = jax.lax.dynamic_slice_in_dim(t["rec_a"], l_lo, nr, axis=0)
        bb = jax.lax.dynamic_slice_in_dim(t["rec_b"], l_lo, nr, axis=0)
        if nr < nc * lc:
            pad = [(0, nc * lc - nr), (0, 0)]
            aa = jnp.pad(aa, pad)
            bb = jnp.pad(bb, pad)
        aa = aa.reshape(nc, lc, L)
        bb = bb.reshape(nc, lc, L)

        # band-local accumulators at the band's m-width: carrying the
        # full-width H through the chunk scan makes every scan step pay a
        # [.., L]-wide carry round trip for a [.., mw]-wide update (early
        # bands waste ~6× at nside=1024); the band result lands in the
        # full accumulators once per band instead of once per chunk
        H0b = jnp.zeros(batch_shape + (nh, mw), dtype=dtype)
        H1b = jnp.zeros_like(H0b)

        def band_step(carry, xs):
            H0b, H1b, lam_p, lam_pp, k, c = carry
            aa_c, bb_c = xs
            l0 = c * lc
            (lam_p, lam_pp, k, _), lam_chunk = _lam_scan_rows(
                l_step, (lam_p, lam_pp, k, l0), aa_c, bb_c
            )
            alm_blk = alm_block_fn(c, l0, lc, mw)[..., :mw]
            lam_c = lam_chunk.astype(alm_blk.real.dtype)
            # consecutive-ℓ rows alternate parity (l0 even: lc is even)
            X0 = jnp.einsum("lrm,...lm->...rm", lam_c[0::2],
                            alm_blk[..., 0::2, :], precision=op.precision)
            X1 = jnp.einsum("lrm,...lm->...rm", lam_c[1::2],
                            alm_blk[..., 1::2, :], precision=op.precision)
            return (H0b + X0, H1b + X1, lam_p, lam_pp, k, c + 1), None

        (H0b, H1b, lam_p, lam_pp, k, _), _ = jax.lax.scan(
            band_step,
            (H0b, H1b, lam_p, lam_pp, k, jnp.asarray(c_lo)),
            (aa, bb),
        )
        H0 = H0.at[..., :mw].add(H0b)
        H1 = H1.at[..., :mw].add(H1b)
        # sequence the unrolled bands: without a barrier XLA may overlap
        # all bands' λ workspaces (observed 74 GB liveness at nside=1024)
        H0, H1, lam_p, lam_pp, k = jax.lax.optimization_barrier(
            (H0, H1, lam_p, lam_pp, k)
        )

    meven = (midx % 2 == 0).astype(jnp.float32)
    Ge = H0 * meven + H1 * (1.0 - meven)
    Go = H0 * (1.0 - meven) + H1 * meven

    if not expand:
        return Ge, Go
    return _expand_rings(op, t, Ge, Go)


def _expand_rings(op, t, Ge, Go):
    """[..., nh, m] even/odd accumulators → all-ring G via N/S mirror."""
    Gn = Ge + Go
    Gs = Ge - Go
    north = jnp.arange(op.nring) < op.nhalf
    return jnp.where(
        north[:, None], Gn[..., t["north_idx"], :], Gs[..., t["mirror"], :]
    )


def synthesis_grid_correlated(op, t, roots, key, z_lo, nz_chunk):
    """Fused correlated-draw + synthesis for one frequency chunk.

    Draws the correlated a_lm for frequencies [z_lo, z_lo+nz_chunk) from
    per-ℓ covariance roots and synthesizes the dense ring-grid maps in one
    streaming program: the ξ white-noise blocks are regenerated per
    parity-packed ℓ-chunk from ``fold_in(key, chunk)`` (identical across
    frequency chunks, so the full cube is drawn from one consistent
    realisation), contracted with the chunk's rows of ``roots``, and fed
    straight into the Legendre contraction (reference behaviour:
    skysim.py:72-136 mkfullsky, but without ever materialising
    alm[nz, L, M]).

    Parameters
    ----------
    roots : [L, nz, nz] real matrix roots of C_l.
    z_lo : traced int — first frequency of the chunk.
    nz_chunk : static int — chunk width.
    """
    nz = roots.shape[-1]

    if "lam" not in t:  # scan mode: Λ-free streamed path
        Ge, Go = _correlated_GeGo_scan(op, t, jnp.asarray(roots), key,
                                       z_lo, nz_chunk)
        return _rings_to_grid_parity(op, t, Ge, Go)

    # parity-packed ell order (matches the Λ chunk layout)
    roots_p = jnp.concatenate([roots[0::2], roots[1::2]], axis=0)

    alm_blk = _make_split_draw_blk(roots_p, key, z_lo, nz_chunk, nz)

    with _stage("legendre"):
        Ge, Go = _legendre_contract_streamed(
            op, t, alm_blk, (nz_chunk, 2), jnp.float32, expand=False
        )
    return _rings_to_grid_parity(op, t, _join_planes(Ge), _join_planes(Go))


def _join_planes(x):
    """[..., 2, r, m] re/im f32 planes → complex64 [..., r, m]."""
    return jax.lax.complex(x[..., 0, :, :], x[..., 1, :, :])


def _make_split_draw_blk(roots_p, key, z_lo, nz_chunk, nz,
                         xi_dtype=jnp.float32):
    """Correlated-draw block producer in split re/im f32 planes.

    Returns ``alm_blk(c, off, nrows, mw) -> [nz_chunk, 2, nrows, mw]``
    (plane axis batched next to frequency).  Both the draw einsum and the
    downstream Legendre einsums then run on purely REAL operands — 2 real
    matmuls per contraction instead of a complex×real dot — and the
    covariance roots are streamed as f32, never upcast to complex64.

    With the default ``xi_dtype`` the ξ values are drawn with the same
    keys/shapes as the former complex path, so realisations are
    stream-identical.  ``xi_dtype=jnp.bfloat16`` halves the random bits
    per value; a bf16 normal is a valid Gaussian draw from a coarser
    (8-bit mantissa) stream, not a rounded copy of the f32 draw, and its
    C_l statistics are χ²-indistinguishable from f32
    (tests/test_skysim.py test_bf16_xi_statistics).  f32 stays the
    default until a chip run shows the bf16 draw winning end to end.
    """
    from jax import lax

    def alm_blk(c, off, nrows, mw):
        with _stage("draw"):
            # only m < mw feeds this chunk's λ (λ ≡ 0 for m > l): drawing
            # the triangle instead of the full [*, L] square halves the
            # step's total RNG volume
            kc = jax.random.fold_in(key, c)
            kr, ki = jax.random.split(kc)
            shape = (nrows, nz, mw)
            half = jnp.asarray(0.70710678, jnp.float32)
            xi = jnp.stack(
                [
                    jax.random.normal(kr, shape, xi_dtype),
                    jax.random.normal(ki, shape, xi_dtype),
                ],
                axis=2,
            ).astype(jnp.float32) * half  # [nrows, nz, 2, mw]
            rblk = lax.dynamic_slice(
                roots_p, (off, z_lo, 0), (nrows, nz_chunk, nz)
            )
            a = jnp.einsum("lzy,lypm->lzpm", rblk, xi,
                           precision=jax.lax.Precision.HIGHEST)
            return jnp.moveaxis(a, 0, 2)  # [nz_chunk, 2, nrows, mw]

    return alm_blk


def _correlated_GeGo(op, t, roots_p, key, z_lo, nz_chunk,
                     xi_dtype=jnp.float32):
    """Even/odd ring accumulators for one frequency chunk of the
    correlated draw (parity-packed roots; see synthesis_grid_correlated).

    Runs in split re/im f32 planes end-to-end (see _make_split_draw_blk);
    planes join to complex only here, at the ring-stage boundary."""
    nz = roots_p.shape[-1]
    alm_blk = _make_split_draw_blk(roots_p, key, z_lo, nz_chunk, nz,
                                   xi_dtype)

    with _stage("legendre"):
        Ge, Go = _legendre_contract_streamed(
            op, t, alm_blk, (nz_chunk, 2), jnp.float32, expand=False
        )
    return _join_planes(Ge), _join_planes(Go)


def _correlated_GeGo_scan(op, t, roots, key, z_lo, nz_chunk,
                          xi_dtype=jnp.float32):
    """Scan-mode (Λ-free) twin of :func:`_correlated_GeGo`.

    roots are plain [L, nz, nz] (consecutive ℓ, not parity-packed); each
    consecutive-ℓ chunk's white noise comes from fold_in(key, c), so all
    frequency chunks of one cube share a single realisation.
    """
    nz = roots.shape[-1]
    # zero-pad roots to a whole number of ℓ-chunks: the streamed band loop
    # slices every chunk at full l_chunk width, and a clamped dynamic_slice
    # on a short last chunk would contract valid λ rows against the WRONG
    # ℓ's covariance roots (the padded λ rows are structurally zero, so
    # padded root rows never contribute)
    L = op.lmax + 1
    Lp = -(-L // op.l_chunk) * op.l_chunk
    if roots.shape[0] < Lp:
        roots = jnp.pad(
            roots, [(0, Lp - roots.shape[0])] + [(0, 0)] * (roots.ndim - 1)
        )

    alm_blk = _make_split_draw_blk(roots, key, z_lo, nz_chunk, nz, xi_dtype)

    with _stage("legendre"):
        Ge, Go = _legendre_contract_scan_streamed(
            op, t, alm_blk, (nz_chunk, 2), jnp.float32, expand=False
        )
    return _join_planes(Ge), _join_planes(Go)


def synthesis_scan_correlated(op, t, roots, key, nz_leg, nz_ring, consume,
                              init, xi_dtype=jnp.float32):
    """Two-level streamed correlated synthesis.

    Level 1 (``nz_leg`` frequencies): the Legendre contraction runs with a
    large matmul row dimension and each ξ
    white-noise block is generated nz/nz_leg times per sweep instead of
    nz/nz_ring (the RNG is ~⅓ of a naive step at the flagship size).
    Level 2 (``nz_ring``): the N/S ring expansion and the ring FFT stage
    run on small slices to bound device memory.

    ``consume(g, z_lo, carry) -> carry`` folds each [nz_ring, nring, nq]
    ring-grid block; the full cube never needs to exist unless the caller
    wants it.
    """
    from jax import lax

    # Sweep bound is the OUTPUT-ROW axis (shape[-2]), not the latent axis:
    # a mesh-sharded caller passes roots rows [L, nloc, nz] and must sweep
    # only its nloc local rows (sweeping nz//nz_leg chunks is benign-but-
    # redundant — the clamped dynamic_slice recomputes row 0's chunks and
    # the sequential fori_loop's last write restores every slot — but costs
    # up to n_dev x the Legendre work per device).
    nz_out = roots.shape[-2]
    if nz_out % nz_leg or nz_leg % nz_ring:
        raise ValueError("nz_leg must divide the output-row count and "
                         "nz_ring divide nz_leg")

    cached = "lam" in t
    roots_p = (
        jnp.concatenate([roots[0::2], roots[1::2]], axis=0) if cached
        else jnp.asarray(roots)
    )

    def leg_body(i, carry):
        z0 = i * nz_leg
        if cached:
            Ge, Go = _correlated_GeGo(op, t, roots_p, key, z0, nz_leg,
                                      xi_dtype)
        else:
            Ge, Go = _correlated_GeGo_scan(op, t, roots_p, key, z0, nz_leg,
                                           xi_dtype)

        def ring_body(j, carry2):
            ge = lax.dynamic_slice_in_dim(Ge, j * nz_ring, nz_ring, axis=0)
            go = lax.dynamic_slice_in_dim(Go, j * nz_ring, nz_ring, axis=0)
            g = _rings_to_grid_parity(op, t, ge, go)
            return consume(g, z0 + j * nz_ring, carry2)

        return lax.fori_loop(0, nz_leg // nz_ring, ring_body, carry)

    return lax.fori_loop(0, nz_out // nz_leg, leg_body, init)


def _legendre_project_cached(op, t, G):
    """Adjoint: alm[..., l, m] = Σ_r λ_lm(θ_r) G[..., r, m], cached-Λ path.

    Parity-packed adjoint of :func:`_legendre_contract_cached`: even-ℓ rows
    draw from the m-parity-matched mix of the north+south / north−south
    accumulators, odd-ℓ rows from the complement — un-masked einsums at
    half the FLOPs, one interleave at the end.
    """
    L = op.lmax + 1
    nh = op.nhalf
    ne = (L + 1) // 2

    # split re/im planes → real-only einsums (see _legendre_contract_cached)
    is_cplx = jnp.iscomplexobj(G)
    if is_cplx:
        G = jnp.stack([G.real, G.imag], axis=-3)

    Gn = G[..., :nh, :]
    Gs = G[..., nh:, :]
    south_idx = t["south_idx"]

    Ge = Gn.at[..., south_idx, :].add(Gs)
    Go = Gn.at[..., south_idx, :].add(-Gs)

    meven = (jnp.arange(L)[None, :] % 2 == 0).astype(G.real.dtype)
    src_even = Ge * meven + Go * (1.0 - meven)  # for even-ℓ rows
    src_odd = Ge * (1.0 - meven) + Go * meven  # for odd-ℓ rows

    parts = {0: [], 1: []}
    for (parity, sub_lo, nrows, _), lam_c in zip(op._lam_meta, t["lam"]):
        mw = min(lam_c.shape[0], L)
        lam = lam_c[:mw, :nrows, :].astype(G.real.dtype)
        srcg = src_even if parity == 0 else src_odd
        out = jnp.einsum("mlr,...rm->...lm", lam, srcg[..., :mw], precision=op.precision)
        pad = L - mw
        if pad:
            out = jnp.pad(out, [(0, 0)] * (out.ndim - 2) + [(0, 0), (0, pad)])
        parts[parity].append(out)

    evens = jnp.concatenate(parts[0], axis=-2)[..., :ne, :]
    odds = jnp.concatenate(parts[1], axis=-2)[..., : L - ne, :]
    if odds.shape[-2] < ne:  # L odd: pad one row for the interleave
        odds = jnp.pad(odds, [(0, 0)] * (odds.ndim - 2) + [(0, 1), (0, 0)])
    alm = jnp.stack([evens, odds], axis=-2)  # [..., ne, 2, M]
    alm = alm.reshape(alm.shape[:-3] + (2 * ne, L))
    alm = alm[..., :L, :]
    if is_cplx:
        alm = _join_planes(alm)
    return alm


def _lam_scale_params(dtype):
    """(scale step S, rescale threshold exponent β) per float dtype.

    Zeroed (still-scaled) entries have true |λ| < 2^{β-S}: 2^-256 in f64
    (exact for any test tolerance), 2^-30 in f32 (below accumulation
    precision).  Thresholds stay far from the dtype's overflow.
    """
    if np.dtype(dtype) == np.dtype(np.float64):
        return 512.0, 256.0
    return 60.0, 30.0


def _scaled_lam_step(lam_mm_s, k0, z, m_arr, out_mw=None):
    """Scaled associated-Legendre recurrence step (libsharp-style).

    λ_mm underflows floating point at high m (log2 λ_mm = m·log2 sinθ —
    beyond even f64 near the poles for lmax ≳ 1500), so the recurrence
    carries λ̃ = λ·2^{60·k} with a per-(ring, m) scale count k: seeds are
    pre-scaled into [2^-30, 2^30) host-side (t["lam_mm"]/t["lam_k0"]) and
    values rescale by exact powers of two as they grow, so results are
    bit-identical to the unscaled recurrence wherever that one doesn't
    under/overflow.  Emitted rows are true λ (zero while still scaled —
    true values there are < 2^-30, below accumulation precision).
    """
    dt = lam_mm_s.dtype
    S, beta = _lam_scale_params(dt)
    THRESH = jnp.asarray(2.0**beta, dt)
    DOWN = jnp.asarray(2.0**-S, dt)
    L = lam_mm_s.shape[1]

    def recur(c, ys):
        lam_p, lam_pp, k, l = c
        a_l, b_l = ys
        lam = a_l[None, :] * z[:, None] * lam_p + b_l[None, :] * lam_pp
        # seed row: inject λ_mm into column m = l as a [nh, 1] column
        # update — the broadcast-mask form re-reads the full seed/k0
        # tables ([nh, L] each) every row.  Zero-padded
        # rows beyond lmax clamp the column index; the select keeps them
        # inert (columns m > l stay exactly zero until their seed row:
        # the recurrence propagates zeros).
        col = jnp.minimum(l, L - 1)
        ok = l < L
        seed_lam = jax.lax.dynamic_slice_in_dim(lam_mm_s, col, 1, axis=1)
        seed_k = jax.lax.dynamic_slice_in_dim(k0, col, 1, axis=1)
        cur_lam = jax.lax.dynamic_slice_in_dim(lam, col, 1, axis=1)
        cur_k = jax.lax.dynamic_slice_in_dim(k, col, 1, axis=1)
        lam = jax.lax.dynamic_update_slice_in_dim(
            lam, jnp.where(ok, seed_lam, cur_lam), col, axis=1
        )
        k = jax.lax.dynamic_update_slice_in_dim(
            k, jnp.where(ok, seed_k, cur_k), col, axis=1
        )
        lam_out = jnp.where(k == 0, lam, 0.0)
        if out_mw is not None:
            lam_out = lam_out[:, :out_mw]
        return (lam, lam_p, k, l + 1), lam_out

    def recur_raw(c, ys):
        # recurrence row WITHOUT the emission mask: the raw (still-scaled)
        # row is emitted and masked at the window level (emit_mask),
        # saving a per-row full-width read of k
        (lam, lam_p, k, l1), _ = recur(c, ys)
        out = lam if out_mw is None else lam[:, :out_mw]
        return (lam, lam_p, k, l1), out

    def emit_mask(c):
        # emission mask of a whole rescale window, from the window-end
        # (pre-rescale) k: within a window k changes only at seed rows,
        # and a column seeded at row l is zero for earlier rows anyway
        # (the recurrence propagates zeros), so one mask serves all rows.
        k = c[2]
        return (k if out_mw is None else k[:, :out_mw]) == 0

    def rescale(c):
        lam_p, lam_pp, k, l = c
        grow = (jnp.abs(lam_p) > THRESH) & (k > 0)
        return (
            jnp.where(grow, lam_p * DOWN, lam_p),
            jnp.where(grow, lam_pp * DOWN, lam_pp),
            jnp.where(grow, k - 1, k),
            l,
        )

    def l_step(c, ys):
        c2, lam_out = recur(c, ys)
        return rescale(c2), lam_out

    # split pieces for the deferred-rescale unrolled scan (_lam_scan_rows):
    # still-scaled values grow by at most (1+sqrt(2))^4 ≈ 2^5.1 between
    # checks, so the emitted-zero bound moves from 2^{β−S} to 2^{β+5.1−S}
    # (f32: 2^-30 → ~3e-8, still below accumulation precision; f64:
    # 2^-250, irrelevant) and λ̃ stays far from overflow.
    l_step.recur_raw = recur_raw
    l_step.emit_mask = emit_mask
    l_step.rescale = rescale
    return l_step


_RESCALE_WINDOW = 4


def _lam_scan_rows(l_step, carry, aa, bb):
    """Scan ``l_step`` over the ℓ-rows of aa/bb [lc, L], several rows per
    scan step, with the rescale check and the emission mask amortised
    over ``_RESCALE_WINDOW``-row windows.

    Per-row full-width selects are the recurrence stage's overhead: the
    k-based emission mask and the seed/rescale bookkeeping each re-read
    [nh, L] state every row.  Inside an unrolled block, rows are generated raw
    (recur_raw), then one window-end mask (emit_mask) zeroes the
    still-scaled entries of all rows in the window and one rescale(c)
    renormalises the carry.  Deferring the rescale moves the
    emitted-zero bound from 2^{β−S} to ~2^{β+5.1−S} (f32: ~3e-8, still
    below accumulation precision — see _scaled_lam_step); window-end
    masking is exact for seed columns because pre-seed rows are zero by
    recurrence.  Equal to the one-row scan at the class documented in
    tests/test_sht.py::test_unrolled_lam_scan_matches_single_row.
    """
    lc = aa.shape[0]
    R = next((r for r in (8, 4, 2) if lc % r == 0), 1)
    recur_raw = getattr(l_step, "recur_raw", None)
    if R == 1 or recur_raw is None:
        return jax.lax.scan(l_step, carry, (aa, bb))
    emit_mask, rescale = l_step.emit_mask, l_step.rescale
    W = _RESCALE_WINDOW

    def blk_step(c, ys):
        ar, br = ys
        outs = []
        for i0 in range(0, R, W):
            raw = []
            for i in range(i0, min(i0 + W, R)):
                c, o = recur_raw(c, (ar[i], br[i]))
                raw.append(o)
            m = emit_mask(c)
            outs.extend(jnp.where(m, o, 0.0) for o in raw)
            c = rescale(c)
        return c, jnp.stack(outs)

    carry, lam = jax.lax.scan(
        blk_step, carry,
        (aa.reshape((lc // R, R) + aa.shape[1:]),
         bb.reshape((lc // R, R) + bb.shape[1:])),
    )
    return carry, lam.reshape((lc,) + lam.shape[2:])


def _ck_override(ck, lam_p, lam_pp, k):
    """Restart the recurrence carry from exact checkpoint rows.

    ck: [2, nh, L] — (λ_{l0-2}, λ_{l0-1}) at this chunk's start, zeros
    where unavailable (chunk 0, underflowed entries, or l < m).  Only
    entries clear of the scaled/underflow region are overridden.
    """
    dt = lam_p.dtype
    use_th = jnp.asarray(2.0**-20, dt)
    c0 = ck[0].astype(dt)
    c1 = ck[1].astype(dt)
    use = (jnp.abs(c0) > use_th) & (jnp.abs(c1) > use_th)
    lam_pp = jnp.where(use, c0, lam_pp)
    lam_p = jnp.where(use, c1, lam_p)
    k = jnp.where(use, jnp.zeros_like(k), k)
    return lam_p, lam_pp, k


def _host_scaled_rows(log2_seed, seed_sign, l0, step):
    """Exact f64 host three-term recurrence in ℓ with libsharp-style
    scaling: yields ``(l, lam, k)`` for l = 0..L-1, where the true row is
    ``where(k == 0, lam, 0)`` (entries still scaled are below 2^-256).

    Seeds far below the f64 range (near the poles at lmax ≳ 3000) would
    otherwise flush to zero or to imprecise subnormals, although their
    columns grow back to O(1) within the band — and inexact carry rows
    built from them would corrupt the checkpointed device scan.

    ``log2_seed``/``seed_sign`` [nh, L]: the seed of column m, injected
    at row ``l0[m]`` (≥ m).  ``step(l, sl, lam_p, out)`` computes the
    unscaled recurrence ``out[:, sl] = f(lam_p, out)`` in place (``out``
    holds row l-2 on entry).  The arrays are reused: copy what is kept.
    """
    S, beta = _lam_scale_params(np.float64)
    k0 = np.ceil(np.maximum(0.0, -(log2_seed + beta) / S))
    with np.errstate(under="ignore"):
        seed = seed_sign * np.exp2(log2_seed + S * k0)
    thresh, down = 2.0**beta, 2.0**-S
    lam_p = np.zeros(log2_seed.shape)
    lam_pp = np.zeros_like(lam_p)
    k = np.zeros_like(lam_p)
    for l in range(log2_seed.shape[1]):
        # columns m > l are zero until their seed row: update the
        # [:, :l+1] triangle only
        sl = slice(0, l + 1)
        lam = lam_pp
        step(l, sl, lam_p, lam)
        cols = np.nonzero(l0 == l)[0]
        lam[:, cols] = seed[:, cols]
        k[:, cols] = k0[:, cols]
        big = (np.abs(lam[:, sl]) > thresh) & (k[:, sl] > 0)
        if big.any():
            lam[:, sl] = np.where(big, lam[:, sl] * down, lam[:, sl])
            lam_p[:, sl] = np.where(big, lam_p[:, sl] * down, lam_p[:, sl])
            k[:, sl] -= big
        lam_pp, lam_p = lam_p, lam
        yield l, lam, k


def _build_lambda_device(op, fdt=np.float32):
    """Materialise the cached parity-packed Λ chunks ON DEVICE.

    Runs the scaled + checkpointed associated-Legendre recurrence (the
    scan-mode machinery: :func:`_scaled_lam_step` / :func:`_ck_override`)
    once over all ℓ and writes the rows straight into the m-major
    ``[mw, nrows, nh]`` chunk layout the cached contraction consumes.
    This replaces the host f64 build (minutes at Nside=512) and its
    multi-GB host→device transfer with on-device work; only the small
    recurrence tables and the 1/(l_chunk·ckpt_every) checkpoint rows are
    transferred.

    Accuracy is the scan-mode class: checkpoint re-seeding bounds the f32
    recurrence error growth to O(l_chunk·ε) — ~1e-6 map RMS, within the
    1e-5 contract.  The host f64 build (``lambda_build="host"``) stays the
    exactness reference (~2e-7 map RMS).

    The reference's libsharp (wrapped at cora/util/hputil.py:195-531)
    regenerates λ rows per transform on the CPU; here the accelerator
    builds its own resident "weights", the way an ML framework initialises
    parameters on device.
    """
    L = op.lmax + 1
    nh = op.nhalf
    lc = op.l_chunk
    if lc % 2:
        raise ValueError("device Λ build requires even l_chunk")
    nchunk = -(-L // lc)
    ke = op.ckpt_every
    meta = op._lam_meta

    # small host-side inputs: recurrence rows + pre-scaled seeds (+ the
    # f64-built checkpoint rows when available — f32 build only: overriding
    # an exact f64 recurrence with f32-cast rows would degrade it)
    S, beta = _lam_scale_params(fdt)
    log2lam = op._log2_lam_mm
    k0 = np.ceil(np.maximum(0.0, -(log2lam + beta) / S))
    with np.errstate(under="ignore"):
        seeds = op._lam_sign * np.exp2(log2lam + S * k0)
    rec_a = _put(op._rec_a.astype(fdt))
    rec_b = _put(op._rec_b.astype(fdt))
    lam_mm = _put(seeds.astype(fdt))
    k0_d = _put(k0.astype(fdt))
    z = _put(op._z_half.astype(fdt))
    ck = (
        _put(op._ck_host)
        if op._ck_host is not None and np.dtype(fdt) == np.dtype(np.float32)
        else None
    )

    # chunk index by (parity, parity-chunk ordinal): scan chunk c feeds its
    # parity-p rows to parity chunk j = c//2 at row offset (c%2)·lc/2
    cidx = {}
    for ci, (p, sub_lo, _, _) in enumerate(meta):
        cidx[(p, sub_lo // lc)] = ci

    # NOTE: np, not jnp — an eager device array captured in the closure
    # becomes a lowering-time trace constant whose value jax fetches from
    # the device.
    m_arr = np.arange(L)

    def build(rec_a, rec_b, lam_mm, k0_d, z, ck):
        outs = [jnp.zeros((mw, nrows, nh), fdt) for (_, _, nrows, mw) in meta]
        lam_p = jnp.zeros((nh, L), fdt)
        lam_pp = jnp.zeros_like(lam_p)
        k = jnp.zeros_like(lam_p)
        for c in range(nchunk):
            if ck is not None and c % ke == 0:
                lam_p, lam_pp, k = _ck_override(ck[c // ke], lam_p, lam_pp, k)
            l0 = c * lc
            mw_c = min(L, ((min(L, (c + 1) * lc) + 127) // 128) * 128)
            l_step = _scaled_lam_step(lam_mm, k0_d, z, m_arr, out_mw=mw_c)
            nr = min(L - l0, lc)
            aa = rec_a[l0 : l0 + nr]
            bb = rec_b[l0 : l0 + nr]
            if nr < lc:  # padded rows have zero rec coeffs → zero λ
                aa = jnp.pad(aa, [(0, lc - nr), (0, 0)])
                bb = jnp.pad(bb, [(0, lc - nr), (0, 0)])
            (lam_p, lam_pp, k, _), lam_chunk = _lam_scan_rows(
                l_step, (lam_p, lam_pp, k, jnp.asarray(l0)), aa, bb
            )
            # consecutive-ℓ rows alternate parity (l0 = c·lc even, lc even):
            # rows p::2 have ℓ-parity p
            j, off = c // 2, (c % 2) * (lc // 2)
            for p in (0, 1):
                ci = cidx.get((p, j))
                if ci is None:
                    continue
                nrows_j, mw_j = meta[ci][2], meta[ci][3]
                nw = min(lc // 2, nrows_j - off)
                if nw <= 0:  # rows past the parity subsequence (tail pad)
                    continue
                blk = lam_chunk[p::2][:nw, :, : min(mw_c, mw_j)]
                blk = jnp.transpose(blk, (2, 0, 1))  # → [mw, nw, nh]
                outs[ci] = jax.lax.dynamic_update_slice(
                    outs[ci], blk, (0, off, 0)
                )
            # sequence the unrolled chunks: bounds the λ-workspace liveness
            # (same pattern as _legendre_contract_scan_streamed)
            sq = jax.lax.optimization_barrier(
                tuple(outs) + (lam_p, lam_pp, k)
            )
            outs = list(sq[: len(meta)])
            lam_p, lam_pp, k = sq[len(meta) :]
        return tuple(outs)

    if ck is not None:
        return jax.jit(build)(rec_a, rec_b, lam_mm, k0_d, z, ck)
    return jax.jit(lambda *a: build(*a, None))(rec_a, rec_b, lam_mm, k0_d, z)


def _legendre_contract_scan(op, t, alm):
    """In-graph recurrence variant (no Λ memory; scaled recurrence keeps
    it correct to arbitrary lmax in f32 or f64).

    With op.scan_ckpt, exact f64-built carry rows re-seed the recurrence
    at each ℓ-chunk boundary (t["lam_ck"]), bounding f32 error growth."""
    L = op.lmax + 1
    nh = op.nhalf

    # split re/im planes → real-only einsums (see _legendre_contract_cached)
    is_cplx = jnp.iscomplexobj(alm)
    if is_cplx:
        alm = jnp.stack([alm.real, alm.imag], axis=-3)

    cdtype = alm.dtype
    z = t["z_half"]

    lc = op.l_chunk
    nchunk = -(-L // lc)
    Lp = nchunk * lc
    if Lp != L:
        pad = [(0, 0)] * (alm.ndim - 2) + [(0, Lp - L), (0, 0)]
        alm = jnp.pad(alm, pad)

    lidx = jnp.arange(Lp)[:, None]
    midx = jnp.arange(L)[None, :]
    even = ((lidx + midx) % 2 == 0).astype(alm.real.dtype)
    alm_even = alm * even
    alm_odd = alm * (1.0 - even)

    def chunkify(x):
        x = jnp.moveaxis(x, -2, 0)
        return x.reshape((nchunk, lc) + x.shape[1:])

    alm_e_c = chunkify(alm_even)
    alm_o_c = chunkify(alm_odd)

    rec_a = jnp.pad(t["rec_a"], ((0, Lp - L), (0, 0)))
    rec_b = jnp.pad(t["rec_b"], ((0, Lp - L), (0, 0)))
    a_c = rec_a.reshape(nchunk, lc, L)
    b_c = rec_b.reshape(nchunk, lc, L)

    lam_mm = t["lam_mm"]
    m_arr = jnp.arange(L)

    batch_shape = alm.shape[:-2]
    Ge0 = jnp.zeros(batch_shape + (nh, L), dtype=cdtype)
    Go0 = jnp.zeros_like(Ge0)
    lam0 = jnp.zeros((nh, L), dtype=lam_mm.dtype)
    l_step = _scaled_lam_step(lam_mm, t["lam_k0"], z, m_arr)
    ck_c = t.get("lam_ck")

    def chunk_step(carry, xs):
        Ge, Go, lam_p, lam_pp, k, l0 = carry
        alm_e, alm_o, aa, bb = xs

        (lam_p, lam_pp, k, lN), lam_chunk = _lam_scan_rows(
            l_step, (lam_p, lam_pp, k, l0), aa, bb
        )
        lam_c = lam_chunk.astype(alm_e.real.dtype)
        Ge = Ge + jnp.einsum("lrm,l...m->...rm", lam_c, alm_e,
                             precision=op.precision)
        Go = Go + jnp.einsum("lrm,l...m->...rm", lam_c, alm_o,
                             precision=op.precision)
        return (Ge, Go, lam_p, lam_pp, k, lN), None

    xs = (alm_e_c, alm_o_c, a_c, b_c)
    carry0 = (Ge0, Go0, lam0, lam0, jnp.zeros_like(lam0), jnp.asarray(0))
    if ck_c is None:
        (Ge, Go, _, _, _, _), _ = jax.lax.scan(chunk_step, carry0, xs)
    else:
        # checkpoint table is per BAND of ckpt_every chunks: scan bands,
        # re-seeding the recurrence carry from exact f64-built rows at each
        # band start, with an inner scan over the band's chunks (matches
        # the streamed path; keeps the stated accuracy contract at
        # ckpt_every > 1, where the old flat scan silently skipped ck)
        g = op.ckpt_every
        nband = -(-nchunk // g)
        ncp = nband * g
        if ncp != nchunk:
            xs = tuple(
                jnp.pad(x, [(0, ncp - nchunk)] + [(0, 0)] * (x.ndim - 1))
                for x in xs
            )
        xs = tuple(x.reshape((nband, g) + x.shape[1:]) for x in xs)

        def band_step(carry, bxs):
            Ge, Go, lam_p, lam_pp, k, l0 = carry
            lam_p, lam_pp, k = _ck_override(bxs[-1], lam_p, lam_pp, k)
            return jax.lax.scan(
                chunk_step, (Ge, Go, lam_p, lam_pp, k, l0), bxs[:-1]
            )

        (Ge, Go, _, _, _, _), _ = jax.lax.scan(
            band_step, carry0, xs + (ck_c,)
        )

    Gn = Ge + Go
    Gs = Ge - Go
    if is_cplx:
        Gn = _join_planes(Gn)
        Gs = _join_planes(Gs)
    north = jnp.arange(op.nring) < nh
    return jnp.where(
        north[:, None], Gn[..., t["north_idx"], :], Gs[..., t["mirror"], :]
    )


def _legendre_project_scan(op, t, G):
    """Adjoint of the scan-mode contraction."""
    L = op.lmax + 1
    nh = op.nhalf

    # split re/im planes → real-only einsums (see _legendre_contract_cached)
    is_cplx = jnp.iscomplexobj(G)
    if is_cplx:
        G = jnp.stack([G.real, G.imag], axis=-3)

    cdtype = G.dtype
    z = t["z_half"]

    Gn = G[..., :nh, :]
    Gs = G[..., nh:, :]
    Ge = Gn.at[..., t["south_idx"], :].add(Gs)
    Go = Gn.at[..., t["south_idx"], :].add(-Gs)

    lc = op.l_chunk
    nchunk = -(-L // lc)
    Lp = nchunk * lc

    rec_a = jnp.pad(t["rec_a"], ((0, Lp - L), (0, 0)))
    rec_b = jnp.pad(t["rec_b"], ((0, Lp - L), (0, 0)))
    a_c = rec_a.reshape(nchunk, lc, L)
    b_c = rec_b.reshape(nchunk, lc, L)

    lam_mm = t["lam_mm"]
    m_arr = jnp.arange(L)
    lam0 = jnp.zeros((nh, L), dtype=lam_mm.dtype)
    l_step = _scaled_lam_step(lam_mm, t["lam_k0"], z, m_arr)
    ck_c = t.get("lam_ck")

    def chunk_step(carry, xs):
        lam_p, lam_pp, k, l0 = carry
        aa, bb = xs

        (lam_p, lam_pp, k, lN), lam_chunk = _lam_scan_rows(
            l_step, (lam_p, lam_pp, k, l0), aa, bb
        )
        lidx = jnp.arange(lc)[:, None, None]
        par = (l0 + lidx + m_arr[None, None, :]) % 2 == 0  # [lc, 1, M]
        lam_e = jnp.where(par, lam_chunk, 0.0).astype(Ge.real.dtype)
        lam_o = jnp.where(par, 0.0, lam_chunk).astype(Ge.real.dtype)
        alm_e = jnp.einsum("lrm,...rm->...lm", lam_e, Ge,
                           precision=op.precision)
        alm_o = jnp.einsum("lrm,...rm->...lm", lam_o, Go,
                           precision=op.precision)
        return (lam_p, lam_pp, k, lN), alm_e + alm_o

    carry0 = (lam0, lam0, jnp.zeros_like(lam0), jnp.asarray(0))
    if ck_c is None:
        _, alm_chunks = jax.lax.scan(chunk_step, carry0, (a_c, b_c))
    else:
        # per-band checkpoint re-seeding (see _legendre_contract_scan)
        g = op.ckpt_every
        nband = -(-nchunk // g)
        ncp = nband * g
        xs = (a_c, b_c)
        if ncp != nchunk:
            xs = tuple(
                jnp.pad(x, [(0, ncp - nchunk)] + [(0, 0)] * (x.ndim - 1))
                for x in xs
            )
        xs = tuple(x.reshape((nband, g) + x.shape[1:]) for x in xs)

        def band_step(carry, bxs):
            lam_p, lam_pp, k, l0 = carry
            lam_p, lam_pp, k = _ck_override(bxs[-1], lam_p, lam_pp, k)
            return jax.lax.scan(
                chunk_step, (lam_p, lam_pp, k, l0), bxs[:-1]
            )

        _, alm_chunks = jax.lax.scan(band_step, carry0, xs + (ck_c,))
        alm_chunks = alm_chunks.reshape(
            (ncp,) + alm_chunks.shape[2:]
        )[:nchunk]
    alm = jnp.moveaxis(alm_chunks, 0, -3)
    alm = alm.reshape(alm.shape[:-3] + (Lp, L))[..., :L, :]
    alm = alm.astype(cdtype)
    if is_cplx:
        alm = _join_planes(alm)
    return alm


def _fft_last(op, t, x, inverse=False):
    """Length-nfft (I)FFT over the last axis: XLA FFT or four-step matmul
    FFT depending on op.fft_mode."""
    if op.fft_mode == "mm":
        n1, n2 = op._fft_n1n2
        key = "ifft" if inverse else "fft"
        tab = {"W1": t[key + "W1"], "T": t[key + "T"], "W2": t[key + "W2"]}
        y = fftmm._apply(x, tab, n1, n2, op.fft_precision, cmul=op.fft_cmul)
        return y / op.nfft if inverse else y
    if inverse:
        return jnp.fft.ifft(x, axis=-1)
    return jnp.fft.fft(x, axis=-1)


def _conv_fam_meta(op, fam):
    """(conv length, (n1, n2)) for a ring-FFT table family: "" = the folded
    Bluestein size nfft, "2" = the foldless size nfft2, "B{n}" = a banded
    cap conv size."""
    if fam == "":
        return op.nfft, op._fft_n1n2
    if fam == "2":
        return op.nfft2, op._fft2_n1n2
    n_b = int(fam[1:])
    return n_b, op._cap_band_ffts[n_b]["n1n2"]


def _conv(op, t, a, fam, kkey, out_len, rows=None, stack2=False, conj=False):
    """Circular convolution IDFT(DFT(a) ∘ K)/n over the last axis.

    ``a`` arrives UNPADDED (its width is the structural in_len hint); the
    kernel K is the device table ``t[kkey]`` (``rows`` slices its ring
    rows, ``stack2`` doubles them for the parity paths, ``conj`` selects
    the adjoint direction).  conv_mode="fused" runs the transpose-free
    four-step form (fftmm.conv_apply: the kernel is stored pre-permuted
    into the digit-reversed [k1, k2] spectrum layout as ``t[kkey+"P"]``);
    "twostep" runs the original forward-multiply-inverse pipeline.
    """
    n, (n1, n2) = _conv_fam_meta(op, fam)
    cdtype = a.dtype
    in_len = a.shape[-1]
    fused = op.fft_mode == "mm" and op.conv_mode == "fused"
    K = t[kkey + "P"] if fused else t[kkey]
    if rows is not None:
        K = K[rows]
    K = K.astype(cdtype)
    if stack2:
        K = jnp.concatenate([K, K], axis=0)
    if conj:
        K = jnp.conj(K)
    a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n - in_len)])
    if fused:
        ft = {"W1": t[f"fft{fam}W1"], "T": t[f"fft{fam}T"],
              "W2": t[f"fft{fam}W2"]}
        it = {"W1": t[f"ifft{fam}W1"], "T": t[f"ifft{fam}T"],
              "W2": t[f"ifft{fam}W2"]}
        return fftmm.conv_apply(
            a, ft, it, K, n1, n2, op.fft_precision,
            in_len=in_len, out_len=out_len, cmul=op.fft_cmul,
        )
    if fam == "":
        return _fft_last(op, t, _fft_last(op, t, a) * K, inverse=True)
    if fam == "2":
        return _fft2_last(
            op, t, _fft2_last(op, t, a, in_len=in_len) * K,
            inverse=True, out_len=out_len,
        )
    return _fftB(
        op, t, _fftB(op, t, a, n, in_len=in_len) * K,
        n, inverse=True, out_len=out_len,
    )


def _rings_to_complex(op, t, G):
    """S(pix) = Σ_{m>=0} G[ring(pix), m] e^{i m φ(pix)} via batched Bluestein."""
    cdtype = G.dtype
    nq_max = t["chirp_A"].shape[-1]

    H = jnp.zeros(G.shape[:-2] + (op.nring, op.nfft), dtype=cdtype)
    Gp = G * t["fold_phase"].astype(cdtype)
    ridx = jnp.broadcast_to(jnp.arange(op.nring)[:, None], t["fold_idx"].shape)
    H = H.at[..., ridx, t["fold_idx"]].add(Gp)

    A = t["chirp_A"].astype(cdtype)

    conv = _conv(op, t, H[..., :nq_max] * A, "", "chirp_Bf", nq_max)
    S = conv[..., :nq_max] * A

    return S[..., t["r_of_pix"], t["j_of_pix"]]


def _map_to_rings(op, t, fmap, cdtype):
    """G[..., r, m] = Σ_j f_j e^{-imφ_j} (forward ring DFTs; real or complex f)."""
    nq_max = t["chirp_A"].shape[-1]
    fr = jnp.zeros(fmap.shape[:-1] + (op.nring, nq_max), dtype=cdtype)
    fr = fr.at[..., t["r_of_pix"], t["j_of_pix"]].set(fmap.astype(cdtype))

    A = t["chirp_A"].astype(cdtype)

    conv = _conv(op, t, jnp.conj(fr) * A, "", "chirp_Bf", nq_max)
    H = jnp.conj(conv[..., :nq_max] * A)

    G = H[..., jnp.arange(op.nring)[:, None], t["fold_idx"]]
    return G * jnp.conj(t["fold_phase"]).astype(cdtype)


def _fft2_last(op, t, x, inverse=False, in_len=None, out_len=None):
    """(I)FFT at the foldless padded size nfft2 (matmul or XLA form).

    in_len/out_len are structural-sparsity hints for the matmul form
    (see fftmm._apply); the XLA form ignores them.
    """
    if op.fft_mode == "mm":
        n1, n2 = op._fft2_n1n2
        key = "ifft2" if inverse else "fft2"
        tab = {"W1": t[key + "W1"], "T": t[key + "T"], "W2": t[key + "W2"]}
        y = fftmm._apply(x, tab, n1, n2, op.fft_precision,
                         in_len=in_len, out_len=out_len, cmul=op.fft_cmul)
        return y / op.nfft2 if inverse else y
    if inverse:
        return jnp.fft.ifft(x, axis=-1)
    return jnp.fft.fft(x, axis=-1)


def _rings_to_grid(op, t, G):
    """Dense ring-grid synthesis: S[..., r, j] for j < n_r via generalized
    Bluestein (M inputs -> n_r outputs; no scatter, no gather)."""
    if op.ring_mode == "split" and "eq_phase" in t:
        return _rings_to_grid_split(op, t, G)
    cdtype = G.dtype
    nq_max = t["bl_C"].shape[-1]

    conv = _conv(op, t, G * t["bl_A"].astype(cdtype), "2", "bl_Bf", nq_max)
    S = conv[..., :nq_max] * t["bl_C"].astype(cdtype)

    # real-field assembly on the grid: f = 2 Re S - Re G_0 (only on
    # valid j < n_r positions; bl_C is zero-masked beyond the ring)
    valid = (t["bl_C"] != 0.0).astype(S.real.dtype)
    return 2.0 * S.real - G[..., 0:1].real * valid


def _grid_to_rings(op, t, fgrid, cdtype):
    """Adjoint: G[..., r, m] = sum_j f[r, j] e^{-i m phi_j} from the dense
    ring grid (chirp-z with n_r inputs and M outputs)."""
    if op.ring_mode == "split" and "eq_phase" in t:
        return _grid_to_rings_split(op, t, fgrid, cdtype)
    L = op.lmax + 1
    a = fgrid.astype(cdtype) * jnp.conj(t["bl_C"]).astype(cdtype)
    conv = _conv(op, t, a, "2", "bl_Bf", L, conj=True)
    # the conjugate-chirp convolution evaluates at integer m positions
    return conv[..., :L] * jnp.conj(t["bl_A"]).astype(cdtype)


def _fftW_last(op, t, x, inverse=False):
    """(I)FFT at the equatorial ring length W = 4·nside."""
    if op.fft_mode == "mm":
        n1, n2 = op._fftW_n1n2
        key = "ifftW" if inverse else "fftW"
        tab = {"W1": t[key + "W1"], "T": t[key + "T"], "W2": t[key + "W2"]}
        y = fftmm._apply(x, tab, n1, n2, op.fft_precision, cmul=op.fft_cmul)
        return y / (4 * op.nside) if inverse else y
    if inverse:
        return jnp.fft.ifft(x, axis=-1)
    return jnp.fft.fft(x, axis=-1)


def _cap_real_synth(op, t, Gcap):
    """Polar-cap real synthesis via the generalized Bluestein convolution."""
    cdtype = Gcap.dtype
    nq_cap = t["bl_C_cap"].shape[-1]
    conv = _conv(
        op, t, Gcap * t["bl_A_cap"].astype(cdtype), "2", "bl_Bf_cap", nq_cap
    )
    S = conv[..., :nq_cap] * t["bl_C_cap"].astype(cdtype)
    valid = (t["bl_C_cap"] != 0.0).astype(S.real.dtype)
    return 2.0 * S.real - Gcap[..., 0:1].real * valid


def _fftB(op, t, x, n_b, inverse=False, in_len=None, out_len=None):
    """(I)FFT at a banded-cap conv size n_b (matmul form only)."""
    n1, n2 = op._cap_band_ffts[n_b]["n1n2"]
    key = "ifftB" if inverse else "fftB"
    tab = {
        "W1": t[f"{key}{n_b}W1"],
        "T": t[f"{key}{n_b}T"],
        "W2": t[f"{key}{n_b}W2"],
    }
    y = fftmm._apply(x, tab, n1, n2, op.fft_precision,
                     in_len=in_len, out_len=out_len, cmul=op.fft_cmul)
    return y / n_b if inverse else y


def _cap_band_conv(op, t, Gcap, b, real_out):
    """One cap band's Bluestein synthesis (see SHT.__init__ cap banding).

    Returns the band's ring rows (north block then south block, matching
    the Gcap slice order) at width q_b; ``real_out`` selects the real-field
    assembly (scalar maps) vs the raw complex sum (spin maps)."""
    i0, i1, M, q, n_b = op._cap_bands[b]
    lo = op._eq_lo
    cdtype = Gcap.dtype
    gn = Gcap[..., i0:i1, :M]
    gs = Gcap[..., 2 * lo - i1: 2 * lo - i0, :M]
    g = jnp.concatenate([gn, gs], axis=-2)
    a = g * t[f"bl_A_cb{b}"].astype(cdtype)
    conv = _conv(op, t, a, f"B{n_b}", f"bl_Bf_cb{b}", q)
    S = conv[..., :q] * t[f"bl_C_cb{b}"].astype(cdtype)
    if not real_out:
        return S
    valid = (t[f"bl_C_cb{b}"] != 0.0).astype(S.real.dtype)
    return 2.0 * S.real - g[..., 0:1].real * valid


def _cap_synth_banded(op, t, Gcap, real_out, out_w):
    """Banded cap synthesis: per-band Bluestein at the band's conv size,
    reassembled into Gcap row order ([north asc; south desc]) at width
    ``out_w``."""
    north, south = [], []
    for b, (i0, i1, M, q, n_b) in enumerate(op._cap_bands):
        f = _cap_band_conv(op, t, Gcap, b, real_out)
        if out_w > q:
            f = jnp.pad(f, [(0, 0)] * (f.ndim - 1) + [(0, out_w - q)])
        rows_n = i1 - i0
        north.append(f[..., :rows_n, :])
        south.append(f[..., rows_n:, :])
    return jnp.concatenate(north + south[::-1], axis=-2)


def _cap_real_synth_banded(op, t, Gcap):
    return _cap_synth_banded(
        op, t, Gcap, True, t["bl_C_cap"].shape[-1]
    )


def _cap_adjoint_banded(op, t, fcap, cdtype):
    """Banded adjoint (analysis direction): dense cap ring rows →
    G[..., r, m] with m truncated to each band's Legendre support (the
    discarded columns only ever multiply λ ≈ 0 in the projection)."""
    L = op.lmax + 1
    lo = op._eq_lo
    north, south = [], []
    for b, (i0, i1, M, q, n_b) in enumerate(op._cap_bands):
        fn_ = fcap[..., i0:i1, :q]
        fs = fcap[..., 2 * lo - i1: 2 * lo - i0, :q]
        f = jnp.concatenate([fn_, fs], axis=-2).astype(cdtype)
        a = f * jnp.conj(t[f"bl_C_cb{b}"]).astype(cdtype)
        conv = _conv(op, t, a, f"B{n_b}", f"bl_Bf_cb{b}", M, conj=True)
        G = conv[..., :M] * jnp.conj(t[f"bl_A_cb{b}"]).astype(cdtype)
        if L > M:
            G = jnp.pad(G, [(0, 0)] * (G.ndim - 1) + [(0, L - M)])
        rows_n = i1 - i0
        north.append(G[..., :rows_n, :])
        south.append(G[..., rows_n:, :])
    return jnp.concatenate(north + south[::-1], axis=-2)


def _cap_sub_batched(op, fn, t, Gcap):
    """Run a per-row cap transform in frequency sub-batches of op.cap_sub.

    The cap Bluestein convolution's nfft2-padded temporaries dominate the
    ring stage's device-memory peak; sequencing it over sub-batches (lax.map = scan)
    bounds the live set so larger frequency chunks fit on-chip.  No-op
    (single fused batch) when cap_sub is unset or doesn't divide the batch.
    """
    s = op.cap_sub
    if s and Gcap.ndim == 3 and Gcap.shape[0] > s and Gcap.shape[0] % s == 0:
        k = Gcap.shape[0] // s
        Gr = Gcap.reshape((k, s) + Gcap.shape[1:])
        out = jax.lax.map(lambda g: fn(op, t, g), Gr)
        return out.reshape((Gcap.shape[0],) + out.shape[2:])
    return fn(op, t, Gcap)


def _eq_real_synth(op, t, A, G0):
    """Real equatorial-band synthesis f = 2·Re Σ_k A_k e^{2πikj/W} − G0
    via Hermitian packing: one complex inverse DFT at W/2.

    2·Re S is the inverse DFT of the Hermitian spectrum
    B_k = A_k + conj(A_{(−k) mod W}); the classic rfft packing evaluates it
    with a half-length complex transform (z_n = f_{2n} + i f_{2n+1}), which
    in matmul-FFT form costs ~3× fewer twiddle MACs than the complex IDFT
    at W.
    """
    cdtype = A.dtype
    W = 4 * op.nside
    W2 = W // 2

    A_rev = jnp.roll(A[..., ::-1], 1, axis=-1)  # A[(−k) mod W]
    B = A + jnp.conj(A_rev)
    B1 = B[..., :W2]
    B2 = B[..., W2:]
    Z = (B1 + B2) + 1j * t["eq_twid"].astype(cdtype) * (B1 - B2)

    # unnormalised positive-exponent DFT of length W/2
    if op.fft_mode == "mm":
        n1, n2 = op._fftW2_n1n2
        tab = {"W1": t["ifftW2W1"], "T": t["ifftW2T"], "W2": t["ifftW2W2"]}
        z = fftmm._apply(Z, tab, n1, n2, op.fft_precision, cmul=op.fft_cmul)
    else:
        z = jnp.fft.ifft(Z, axis=-1) * W2

    f = jnp.stack([z.real, z.imag], axis=-1).reshape(z.shape[:-1] + (W,))
    return f - G0


def _cap_sub_batched2(op, fn, t, Ge, Go):
    """Pair twin of :func:`_cap_sub_batched` for the parity cap synthesis
    (sub-batches the even/odd accumulators together)."""
    s = op.cap_sub
    if s and Ge.ndim == 3 and Ge.shape[0] > s and Ge.shape[0] % s == 0:
        k = Ge.shape[0] // s
        Ger = Ge.reshape((k, s) + Ge.shape[1:])
        Gor = Go.reshape((k, s) + Go.shape[1:])
        out = jax.lax.map(lambda ab: fn(op, t, ab[0], ab[1]), (Ger, Gor))
        return out.reshape((Ge.shape[0],) + out.shape[2:])
    return fn(op, t, Ge, Go)


def _cap_real_synth_parity(op, t, Ge, Go):
    """Dense-cap Bluestein synthesis from the even/odd accumulators.

    North cap row r < lo: f = T(Gn)[r] with Gn = Ge + Go; its mirror
    (global row nring−1−r) is T(Gs)[r] with Gs = Ge − Go and the SAME
    chirp/kernel rows (mirror tables are bitwise equal — op._ns_symmetric).
    The convolution is real-linear, so run it once on the stacked
    [Ge; Go] cap rows and form the ± combinations on the (narrower, real)
    outputs — the expanded full-ring G never exists.

    Returns fcap in the Gcap row order of :func:`_cap_real_synth`
    ([north asc; south asc-by-global-row]).
    """
    cdtype = Ge.dtype
    lo = op._eq_lo
    nq_cap = t["bl_C_cap"].shape[-1]
    A_n = t["bl_A_cap"][:lo].astype(cdtype)
    C_n = t["bl_C_cap"][:lo].astype(cdtype)

    g = jnp.concatenate([Ge[..., :lo, :], Go[..., :lo, :]], axis=-2)
    a = g * jnp.concatenate([A_n, A_n], axis=0)
    conv = _conv(
        op, t, a, "2", "bl_Bf_cap", nq_cap,
        rows=slice(0, lo), stack2=True,
    )
    Se = conv[..., :lo, :nq_cap]
    So = conv[..., lo:, :nq_cap]
    valid = (C_n != 0.0).astype(jnp.float32)
    # 2·Re((Se ± So)·C) − Re(Ge ± Go)_0, still in north row order
    SnC = (Se + So) * C_n
    SsC = (Se - So) * C_n
    fn_ = 2.0 * SnC.real - (Ge + Go)[..., :lo, 0:1].real * valid
    fs = 2.0 * SsC.real - (Ge - Go)[..., :lo, 0:1].real * valid
    # south rows ascend in global index = DESCENDING northern mirror index
    return jnp.concatenate([fn_, fs[..., ::-1, :]], axis=-2)


def _cap_band_conv_parity(op, t, Ge, Go, b, real_out):
    """Parity twin of :func:`_cap_band_conv` — see _cap_real_synth_parity."""
    i0, i1, M, q, n_b = op._cap_bands[b]
    R = i1 - i0
    cdtype = Ge.dtype
    A_n = t[f"bl_A_cb{b}"][:R].astype(cdtype)
    C_n = t[f"bl_C_cb{b}"][:R].astype(cdtype)

    g = jnp.concatenate(
        [Ge[..., i0:i1, :M], Go[..., i0:i1, :M]], axis=-2
    )
    a = g * jnp.concatenate([A_n, A_n], axis=0)
    conv = _conv(
        op, t, a, f"B{n_b}", f"bl_Bf_cb{b}", q,
        rows=slice(0, R), stack2=True,
    )
    Se = conv[..., :R, :q]
    So = conv[..., R:, :q]
    SnC = (Se + So) * C_n
    SsC = (Se - So) * C_n
    if not real_out:
        return SnC, SsC[..., ::-1, :]
    valid = (C_n != 0.0).astype(jnp.float32)
    fn_ = 2.0 * SnC.real - (Ge + Go)[..., i0:i1, 0:1].real * valid
    fs = 2.0 * SsC.real - (Ge - Go)[..., i0:i1, 0:1].real * valid
    return fn_, fs[..., ::-1, :]


def _cap_real_synth_banded_parity(op, t, Ge, Go):
    """Banded parity cap synthesis, assembled in Gcap row order."""
    out_w = t["bl_C_cap"].shape[-1]
    north, south = [], []
    for b in range(len(op._cap_bands)):
        q = op._cap_bands[b][3]
        fn_, fs = _cap_band_conv_parity(op, t, Ge, Go, b, True)
        if out_w > q:
            padc = [(0, 0)] * (fn_.ndim - 1) + [(0, out_w - q)]
            fn_ = jnp.pad(fn_, padc)
            fs = jnp.pad(fs, padc)
        north.append(fn_)
        south.append(fs)
    return jnp.concatenate(north + south[::-1], axis=-2)


def _rings_to_grid_parity(op, t, Ge, Go):
    """Dense ring-grid synthesis straight from the even/odd accumulators.

    :func:`_expand_rings` materialises the full [..., nring, M] complex G
    (a where + two gathers over HBM) only for the split ring stage to
    re-slice it into eq/cap row blocks.  All ring transforms are
    real-linear and the mirror tables are bitwise equal
    (op._ns_symmetric), so south rows are T(Ge) − T(Go) with rows
    reversed: run each transform on the stacked half-size accumulators
    and combine on the small real outputs instead.  Falls back to
    expand + :func:`_rings_to_grid` when the fast-path preconditions
    don't hold.
    """
    if not (op.ring_mode == "split" and "eq_phase" in t
            and getattr(op, "_ns_symmetric", False)
            and jnp.iscomplexobj(Ge)):
        return _rings_to_grid(op, t, _expand_rings(op, t, Ge, Go))

    cdtype = Ge.dtype
    lo, hi = op._eq_lo, op._eq_hi
    nh = op.nhalf
    W = 4 * op.nside
    nq_max = t["bl_C"].shape[-1]
    n_eq_n = nh - lo  # north eq rows incl. the (self-mirrored) equator
    n_eq_s = hi - nh

    with _stage("ring_eq"):
        phase_n = t["eq_phase"][:n_eq_n].astype(cdtype)
        A = jnp.concatenate(
            [Ge[..., lo:nh, :], Go[..., lo:nh, :]], axis=-2
        ) * jnp.concatenate([phase_n, phase_n], axis=0)
        Lp = A.shape[-1]
        if Lp % W:
            A = jnp.pad(A, [(0, 0)] * (A.ndim - 1) + [(0, W - Lp % W)])
        A = A.reshape(A.shape[:-1] + (-1, W)).sum(axis=-2)  # alias m mod W
        fboth = _eq_real_synth(op, t, A, jnp.float32(0.0))
        fe = fboth[..., :n_eq_n, :]
        fo = fboth[..., n_eq_n:, :]
        f_north = (fe + fo) - (Ge + Go)[..., lo:nh, 0:1].real
        f_south = (
            (fe - fo)[..., :n_eq_s, :]
            - (Ge - Go)[..., lo: nh - 1, 0:1].real
        )[..., ::-1, :]
        feq = jnp.concatenate([f_north, f_south], axis=-2)
        if nq_max > W:
            feq = jnp.pad(feq, [(0, 0)] * (feq.ndim - 1) + [(0, nq_max - W)])

    if lo == 0 and hi == op.nring:
        return feq

    with _stage("ring_cap"):
        nq_cap = t["bl_C_cap"].shape[-1]
        cap_fn = (_cap_real_synth_banded_parity if op._cap_bands is not None
                  else _cap_real_synth_parity)
        fcap = _cap_sub_batched2(op, cap_fn, t, Ge, Go)
        if nq_max > nq_cap:
            fcap = jnp.pad(
                fcap, [(0, 0)] * (fcap.ndim - 1) + [(0, nq_max - nq_cap)]
            )

    return jnp.concatenate(
        [fcap[..., :lo, :], feq, fcap[..., lo:, :]], axis=-2
    )


def _rings_to_grid_split(op, t, G):
    """Ring synthesis with the equatorial fast path.

    The 2·nside+1 equatorial-band rings all have length W = 4·nside and
    account for ~⅔ of the pixels; their DFTs run as ONE batched
    matmul-IFFT at W (phases e^{imφ0} folded in, m aliased mod W) —
    ¼ the work of the padded Bluestein convolution, which now covers
    only the polar-cap rings.
    """
    cdtype = G.dtype
    lo, hi = op._eq_lo, op._eq_hi
    W = 4 * op.nside
    nq_max = t["bl_C"].shape[-1]

    # --- equatorial band: Hermitian-packed real inverse DFT at W/2
    with _stage("ring_eq"):
        A = G[..., lo:hi, :] * t["eq_phase"].astype(cdtype)
        Lp = A.shape[-1]
        if Lp % W:
            A = jnp.pad(A, [(0, 0)] * (A.ndim - 1) + [(0, W - Lp % W)])
        A = A.reshape(A.shape[:-1] + (-1, W)).sum(axis=-2)  # alias m mod W
        feq = _eq_real_synth(op, t, A, G[..., lo:hi, 0:1].real)
        if nq_max > W:
            feq = jnp.pad(feq, [(0, 0)] * (feq.ndim - 1) + [(0, nq_max - W)])

    if lo == 0 and hi == op.nring:
        return feq

    # --- polar caps: generalized Bluestein on the cap rows only
    with _stage("ring_cap"):
        Gcap = jnp.concatenate([G[..., :lo, :], G[..., hi:, :]], axis=-2)
        nq_cap = t["bl_C_cap"].shape[-1]
        cap_fn = (_cap_real_synth_banded if op._cap_bands is not None
                  else _cap_real_synth)
        fcap = _cap_sub_batched(op, cap_fn, t, Gcap)
        if nq_max > nq_cap:
            fcap = jnp.pad(
                fcap, [(0, 0)] * (fcap.ndim - 1) + [(0, nq_max - nq_cap)]
            )

    return jnp.concatenate(
        [fcap[..., :lo, :], feq, fcap[..., lo:, :]], axis=-2
    )


def _rings_to_grid_complex(op, t, G):
    """Complex ring evaluation S[..., r, j] = Σ_{m≥0} G_rm e^{imφ_rj} on the
    dense ring grid — no real-field assembly (spin-weighted maps Q ± iU
    are complex; cora_tpu.healpix.spin builds on this).

    Positions j ≥ n_r are zero-masked.
    """
    cdtype = G.dtype
    nq_max = t["bl_C"].shape[-1]

    if op.ring_mode == "split" and "eq_phase" in t:
        lo, hi = op._eq_lo, op._eq_hi
        W = 4 * op.nside

        A = G[..., lo:hi, :] * t["eq_phase"].astype(cdtype)
        Lp = A.shape[-1]
        if Lp % W:
            A = jnp.pad(A, [(0, 0)] * (A.ndim - 1) + [(0, W - Lp % W)])
        A = A.reshape(A.shape[:-1] + (-1, W)).sum(axis=-2)
        Seq = _fftW_last(op, t, A, inverse=True) * W
        if nq_max > W:
            Seq = jnp.pad(Seq, [(0, 0)] * (Seq.ndim - 1) + [(0, nq_max - W)])

        if lo == 0 and hi == op.nring:
            return Seq

        Gcap = jnp.concatenate([G[..., :lo, :], G[..., hi:, :]], axis=-2)
        nq_cap = t["bl_C_cap"].shape[-1]
        if op._cap_bands is not None:
            Scap = _cap_synth_banded(op, t, Gcap, False, nq_cap)
        else:
            a = Gcap * t["bl_A_cap"].astype(cdtype)
            conv = _conv(op, t, a, "2", "bl_Bf_cap", nq_cap)
            Scap = conv[..., :nq_cap] * t["bl_C_cap"].astype(cdtype)
        if nq_max > nq_cap:
            Scap = jnp.pad(
                Scap, [(0, 0)] * (Scap.ndim - 1) + [(0, nq_max - nq_cap)]
            )
        return jnp.concatenate(
            [Scap[..., :lo, :], Seq, Scap[..., lo:, :]], axis=-2
        )

    conv = _conv(op, t, G * t["bl_A"].astype(cdtype), "2", "bl_Bf", nq_max)
    return conv[..., :nq_max] * t["bl_C"].astype(cdtype)


def _grid_to_rings_split(op, t, fgrid, cdtype):
    """Adjoint of :func:`_rings_to_grid_split`."""
    lo, hi = op._eq_lo, op._eq_hi
    W = 4 * op.nside
    L = op.lmax + 1

    # --- equatorial band: forward DFT at W, replicate bins for m >= W
    feq = fgrid[..., lo:hi, :W].astype(cdtype)
    F = _fftW_last(op, t, feq, inverse=False)
    reps = -(-L // W)
    if reps > 1:
        F = jnp.tile(F, (1,) * (F.ndim - 1) + (reps,))
    Geq = F[..., :L] * jnp.conj(t["eq_phase"]).astype(cdtype)

    if lo == 0 and hi == op.nring:
        return Geq

    # --- polar caps: conjugate-chirp Bluestein on cap rows
    nq_cap = t["bl_C_cap"].shape[-1]
    fcap = jnp.concatenate(
        [fgrid[..., :lo, :], fgrid[..., hi:, :]], axis=-2
    )[..., :nq_cap]
    if op._cap_bands is not None:
        Gcap = _cap_adjoint_banded(op, t, fcap, cdtype)
        return jnp.concatenate(
            [Gcap[..., :lo, :], Geq, Gcap[..., lo:, :]], axis=-2
        )
    a = fcap.astype(cdtype) * jnp.conj(t["bl_C_cap"]).astype(cdtype)
    conv = _conv(op, t, a, "2", "bl_Bf_cap", L, conj=True)
    Gcap = conv[..., :L] * jnp.conj(t["bl_A_cap"]).astype(cdtype)

    return jnp.concatenate(
        [Gcap[..., :lo, :], Geq, Gcap[..., lo:, :]], axis=-2
    )


def _synthesis_grid(op, t, alm):
    """alm -> dense ring-grid map [..., nring, nq_max] (gather-free path)."""
    if "lam" in t:
        G = _legendre_contract_cached(op, t, alm)
    else:
        G = _legendre_contract_scan(op, t, alm)
    return _rings_to_grid(op, t, G)


def _analysis_once_grid(op, t, fgrid, cdtype):
    G = _grid_to_rings(op, t, fgrid, cdtype)
    G = G * (4.0 * np.pi / op.npix)
    if "lam" in t:
        return _legendre_project_cached(op, t, G)
    return _legendre_project_scan(op, t, G)


def _analysis_grid(op, t, fgrid, iter):
    cdtype = jnp.complex128 if fgrid.dtype == jnp.float64 else jnp.complex64
    alm = _analysis_once_grid(op, t, fgrid, cdtype)
    for _ in range(iter):
        resid = fgrid - _synthesis_grid(op, t, alm)
        alm = alm + _analysis_once_grid(op, t, resid, cdtype)
    return alm


def _analysis_cg_impl(op, t, f, niter, synth_fn, proj_fn):
    """Conjugate-gradient map2alm (normal equations); layout-agnostic core.

    Solves (AᵀWA) x = AᵀW m with A = synthesis — converges substantially
    faster per iteration than the Jacobi refinement healpy offers (each CG
    step costs one synthesis + one adjoint, same as one Jacobi step).

    The m ≥ 0 packed alm representation weights m > 0 modes twice in the
    real map inner product, so CG runs in rescaled variables y = s_m·x
    (s = √2 for m > 0) where the normal operator is self-adjoint under the
    plain complex dot product.

    CG is hand-rolled over lax.fori_loop (not jax.scipy.sparse.linalg.cg,
    whose custom_linear_solve machinery fails to trace the lax.scan-based
    Legendre operator on jax 0.8) — one SHT pair per iteration, same cost
    as a Jacobi step.

    ``synth_fn(op, t, alm)`` / ``proj_fn(op, t, f, cdtype)`` select the
    layout: ring grid (_synthesis_grid/_analysis_once_grid) or HEALPix
    pixels (_synthesis/_analysis_once).
    """
    from jax import lax

    cdtype = jnp.complex128 if f.dtype == jnp.float64 else jnp.complex64
    L = op.lmax + 1
    s = jnp.where(jnp.arange(L)[None, :] > 0, np.sqrt(2.0), 1.0).astype(
        jnp.float32 if cdtype == jnp.complex64 else jnp.float64
    )

    def N(y):
        x = y / s
        g = synth_fn(op, t, x)
        return proj_fn(op, t, g, cdtype) * s

    def dot(u, v):
        return jnp.sum(jnp.real(jnp.conj(u) * v))

    b = proj_fn(op, t, f, cdtype) * s
    x0 = b
    r0 = b - N(x0)
    rs0 = dot(r0, r0)
    # un-guarded CG diverges violently once the residual reaches rounding
    # level (r becomes pure noise and pᵀNp can round toward 0), so (a)
    # freeze the iteration when ‖r‖ hits ~50·eps of its start or grows
    # well past its best, and (b) return the lowest-residual iterate seen
    eps = jnp.finfo(r0.real.dtype).eps
    tol2 = rs0 * (50.0 * eps) ** 2

    def body(_, carry):
        x, r, p, rs, xb, rs_min = carry
        live = (rs > tol2) & (rs < 1e6 * rs_min)
        Np = N(p)
        denom = dot(p, Np)
        alpha = jnp.where(
            live & (denom > 0), rs / jnp.maximum(denom, 1e-300), 0.0
        )
        x = x + alpha * p
        r = r - alpha * Np
        rs_new = jnp.where(live, dot(r, r), rs)
        beta = jnp.where(
            live & (rs > 0), rs_new / jnp.maximum(rs, 1e-300), 0.0
        )
        p = jnp.where(live, r + beta * p, p)
        better = rs_new < rs_min
        xb = jnp.where(better, x, xb)
        rs_min = jnp.where(better, rs_new, rs_min)
        return x, r, p, rs_new, xb, rs_min

    _, _, _, _, y, _ = lax.fori_loop(
        0, niter, body, (x0, r0, r0, rs0, x0, rs0)
    )
    return y / s


def _analysis_cg_grid(op, t, fgrid, niter):
    """CG map2alm from the dense ring-grid layout."""
    return _analysis_cg_impl(
        op, t, fgrid, niter, _synthesis_grid, _analysis_once_grid
    )


def _analysis_cg(op, t, fmap, niter):
    """CG map2alm from HEALPix pixel ordering."""
    return _analysis_cg_impl(op, t, fmap, niter, _synthesis, _analysis_once)


_synthesis_grid_jit = jax.jit(_synthesis_grid, static_argnums=0)
_analysis_grid_jit = jax.jit(_analysis_grid, static_argnums=(0, 3))
_analysis_cg_grid_jit = jax.jit(_analysis_cg_grid, static_argnums=(0, 3))
_analysis_cg_jit = jax.jit(_analysis_cg, static_argnums=(0, 3))


def _synthesis(op, t, alm):
    if "lam" in t:
        G = _legendre_contract_cached(op, t, alm)
    else:
        G = _legendre_contract_scan(op, t, alm)
    S = _rings_to_complex(op, t, G)
    G0 = G[..., t["r_of_pix"], 0]
    return 2.0 * S.real - G0.real


def _analysis_once(op, t, fmap, cdtype):
    G = _map_to_rings(op, t, fmap, cdtype)
    G = G * (4.0 * np.pi / op.npix)
    if "lam" in t:
        return _legendre_project_cached(op, t, G)
    return _legendre_project_scan(op, t, G)


def _analysis(op, t, fmap, iter):
    cdtype = jnp.complex128 if fmap.dtype == jnp.float64 else jnp.complex64
    alm = _analysis_once(op, t, fmap, cdtype)
    for _ in range(iter):
        resid = fmap - _synthesis(op, t, alm)
        alm = alm + _analysis_once(op, t, resid, cdtype)
    return alm


_synthesis_jit = jax.jit(_synthesis, static_argnums=0)
_analysis_jit = jax.jit(_analysis, static_argnums=(0, 3))


# ===========================================================================
# Operator class: host-side geometry + device table management
# ===========================================================================


class SHT:
    """Spherical-harmonic transform operator for one (nside, lmax) pair.

    Parameters
    ----------
    nside, lmax : int
    l_chunk : int
        Chunk length for the Legendre stage (matmul depth per einsum).
    legendre_mode : {"scan", "cached"}
        "scan": in-graph f64 recurrence (exact; CPU/tests).
        "cached": precomputed float32 Λ chunks resident on device — the
        accelerator production path (no f64 on device, flat compile
        time).
    """

    def __init__(
        self,
        nside: int,
        lmax: int,
        l_chunk: int = 64,
        legendre_mode: str = "scan",
        cache_dtype=np.float32,
        fft_mode: str = "xla",
        ring_mode: str = "split",
        precision: str = "highest",
        lambda_cache: str | None = None,
        cap_sub: int | None = None,
        scan_ckpt: bool = False,
        ckpt_cache: str | None = None,
        ckpt_every: int = 1,
        cap_bands: int | None = None,
        lambda_build: str = "host",
        fft_cmul: str = "xla",
        fft_precision: str | None = None,
        conv_mode: str | None = None,
    ):
        self.nside = int(nside)
        self.lmax = int(lmax)
        self.npix = pixel.nside2npix(nside)
        self.l_chunk = int(l_chunk)
        self.legendre_mode = legendre_mode
        self.cache_dtype = cache_dtype
        self.fft_mode = fft_mode
        self.ring_mode = ring_mode
        # frequency sub-batch width for the cap Bluestein convolution
        # (bounds the ring-stage memory peak; see _cap_sub_batched)
        self.cap_sub = int(cap_sub) if cap_sub else None
        # matmul precision for the deterministic transform contractions:
        # an f32 dot with no precision may run in TF32 or bf16 passes on
        # an accelerator (~1e-3 class); "highest" is true f32 and meets
        # the 1e-5 accuracy contract.
        self.precision = precision
        # complex-matmul lowering for the matmul-FFT stages: "xla" (4 real
        # dots) or "karatsuba" (3 real dots — 25% fewer matmul FLOPs, one
        # extra elementwise pass; exactness asserted in tests/test_sht.py)
        self.fft_cmul = fft_cmul
        # separate precision for the ring-FFT matmuls: the Legendre
        # contraction keeps `precision`, the twiddle DFTs may run at a
        # lower one when a measurement shows the map contract holds
        self.fft_precision = precision if fft_precision is None else fft_precision
        # Bluestein convolution form under fft_mode="mm": "fused" chains
        # forward and inverse four-step DFTs through the digit-reversed
        # [k1, k2] spectrum layout (fftmm.conv_apply — zero transposes,
        # kernel multiply fused between matmuls); "twostep" is the
        # original forward → multiply → inverse pipeline, kept for
        # measurement and as the equality reference (tests/test_sht.py).
        # Size-gated default (fused at nside >= 512), kept from the
        # earlier accelerator's measurements until the ring-FFT form is
        # settled on the GPU (ROADMAP Speed 2).
        if conv_mode is None:
            conv_mode = (
                "fused" if fft_mode == "mm" and self.nside >= 512
                else "twostep"
            )
        if conv_mode not in ("fused", "twostep"):
            raise ValueError(f"unknown conv_mode {conv_mode!r}")
        if conv_mode == "fused" and fft_mode != "mm":
            raise ValueError("conv_mode='fused' requires fft_mode='mm'")
        self.conv_mode = conv_mode

        info = pixel.ring_info(nside)
        nring = info["theta"].size
        self.nring = nring
        self.nhalf = 2 * nside  # northern rings incl. equator

        theta = info["theta"]
        self._nq = info["nphi"]
        self._phi0 = info["phi0"]
        self._start = info["start"]

        nh = self.nhalf
        self._z_half = np.cos(theta[:nh])
        self._sth_half = np.sin(theta[:nh])

        # --- recurrence coefficients a[l, m], b[l, m] (host, float64) ---
        L = lmax + 1
        l = np.arange(L)[:, None].astype(np.float64)
        m = np.arange(L)[None, :].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.sqrt((4 * l**2 - 1.0) / (l**2 - m**2))
            b = -np.sqrt(
                ((2 * l + 1.0) / (2 * l - 3.0))
                * ((l - 1) ** 2 - m**2)
                / (l**2 - m**2)
            )
        valid = l > m
        self._rec_a = np.where(valid, a, 0.0)
        self._rec_b = np.where(valid, b, 0.0)

        # --- λ_mm seeds [nhalf, L] via log-space cumulative product ---
        mm = np.arange(L)[None, :].astype(np.float64)
        ln_sth = np.log(self._sth_half)[:, None]
        ratio = 0.5 * np.concatenate(
            [[0.0], np.log((2 * np.arange(1, L) + 1.0) / (2 * np.arange(1, L)))]
        )
        ln_lam = (
            0.5 * np.log(1.0 / (4 * np.pi)) + np.cumsum(ratio)[None, :] + mm * ln_sth
        )
        sign = np.where(np.arange(L)[None, :] % 2 == 0, 1.0, -1.0)
        with np.errstate(under="ignore"):
            self._lam_mm = sign * np.exp(ln_lam)

        # --- scaled-recurrence seeds (libsharp-style): λ_mm underflows
        # even f64 at high m near the poles (log2 λ_mm = m·log2 sinθ), so
        # the scan-mode device recurrence carries λ̃ = λ·2^{S·k} with a
        # per-(ring, m) integer scale k, rescaling by exact powers of two
        # as values grow.  Seeds/k0 are built per dtype in _make_tables
        # (S, β) = (512, 256) for f64 (zeroing bound 2^-256: exact) and
        # (60, 30) for f32 (bound 2^-30, far below f32 accumulation).
        self._log2_lam_mm = ln_lam / np.log(2.0)
        self._lam_sign = sign

        # --- Bluestein chirp tables ---
        nq_max = int(self._nq.max())
        self.nfft = _next_fft_size(2 * nq_max)
        t = np.arange(nq_max)
        nq_f = self._nq.astype(np.float64)[:, None]

        karr = t[None, :]
        mask = karr < self._nq[:, None]
        self._chirp_A = (np.exp(1j * np.pi * karr**2 / nq_f) * mask).astype(
            np.complex128
        )

        c = np.zeros((nring, self.nfft), dtype=np.complex128)
        for r in range(nring):
            n = int(self._nq[r])
            tt = np.arange(n)
            w = np.exp(-1j * np.pi * tt**2 / n)
            c[r, :n] = w
            c[r, self.nfft - n + 1 :] += w[1:][::-1]
        self._chirp_Bf = np.fft.fft(c, axis=-1)

        # matmul-FFT twiddle tables (host)
        self._fftmm_tabs = fftmm.dft_tables(self.nfft, dtype=np.complex128)
        self._fft_n1n2 = self._fftmm_tabs["n1n2"]

        # --- m-folding and map-assembly index tables ---
        marr = np.arange(L)[None, :]
        self._fold_phase = np.exp(1j * marr * self._phi0[:, None])
        self._fold_idx = (marr % self._nq[:, None]).astype(np.int32)

        # --- foldless (generalized Bluestein) tables: evaluate
        # S[r, j] = sum_m G[r, m] e^{i m (phi0_r + 2 pi j / n_r)} directly
        # as a chirp-z transform with M inputs and n_r outputs — no
        # m-folding scatter, no pixel gather (output stays on the dense
        # ring grid).  Phases are computed mod 2 in exact integer
        # arithmetic to keep f64 accuracy at large m^2.
        mm2 = marr.astype(np.int64) ** 2
        jj = np.arange(nq_max)
        jj2 = jj.astype(np.int64)[None, :] ** 2
        nqc = self._nq[:, None].astype(np.int64)

        def _chirp(num2, nq):
            # e^{i pi num2 / nq} with num2 mod (2 nq) for accuracy
            red = np.mod(num2, 2 * nq)
            return np.exp(1j * np.pi * red / nq)

        # A2[r, m] = e^{i m phi0_r} e^{i pi m^2 / n_r}
        self._bl_A = (self._fold_phase * _chirp(mm2, nqc)).astype(np.complex128)
        # C[r, j] = e^{i pi j^2 / n_r}, masked to j < n_r
        self._bl_C = (_chirp(jj2, nqc) * (jj[None, :] < self._nq[:, None])).astype(
            np.complex128
        )
        # b kernel: w_d = e^{-i pi d^2 / n_r}, symmetric coverage
        # d in [-(Dmax), +Dmax] with Dmax = max(M, nq_max) - 1 (serves both
        # the synthesis (d = j - m) and analysis (d = m - j) directions)
        Dmax = max(L, nq_max) - 1
        nfft2 = _next_fft_size(2 * Dmax + 1)
        self.nfft2 = nfft2
        c2 = np.zeros((nring, nfft2), dtype=np.complex128)
        for r in range(nring):
            n = int(self._nq[r])
            dpos = np.arange(Dmax + 1)
            w = np.exp(-1j * np.pi * np.mod(dpos.astype(np.int64) ** 2, 2 * n) / n)
            c2[r, : Dmax + 1] = w
            c2[r, nfft2 - Dmax :] += w[1:][::-1]
        self._bl_Bf = np.fft.fft(c2, axis=-1)
        self._fftmm2_tabs = fftmm.dft_tables(nfft2, dtype=np.complex128)
        self._fft2_n1n2 = self._fftmm2_tabs["n1n2"]

        # --- equatorial-band fast path (ring_mode="split"): the contiguous
        # run of rings with n_r == 4*nside skips Bluestein entirely — one
        # batched (I)DFT at W with phases folded in; the padded chirp
        # convolution then covers only the polar caps (~1/3 of pixels).
        W = 4 * self.nside
        eqmask = self._nq == W
        if eqmask.any():
            self._eq_lo = int(np.argmax(eqmask))
            self._eq_hi = int(len(eqmask) - np.argmax(eqmask[::-1]))
        else:  # degenerate; never true for HEALPix
            self._eq_lo = self._eq_hi = 0
        self._eq_phase = np.exp(
            1j
            * np.arange(L)[None, :]
            * self._phi0[self._eq_lo : self._eq_hi, None]
        )
        self._fftmmW_tabs = fftmm.dft_tables(W, dtype=np.complex128)
        self._fftW_n1n2 = self._fftmmW_tabs["n1n2"]
        # half-length tables for the real-output equatorial synthesis: the
        # Hermitian-packed inverse DFT runs at W/2 (~3x fewer twiddle MACs
        # in matmul form than the complex IDFT at W)
        self._fftmmW2_tabs = fftmm.dft_tables(W // 2, dtype=np.complex128)
        self._fftW2_n1n2 = self._fftmmW2_tabs["n1n2"]
        self._eq_twid = np.exp(2j * np.pi * np.arange(W // 2) / W)
        lo, hi = self._eq_lo, self._eq_hi
        nq_cap = int(self._nq[: lo].max()) if lo else 0
        self._bl_A_cap = np.concatenate([self._bl_A[:lo], self._bl_A[hi:]], 0)
        self._bl_C_cap = np.concatenate(
            [self._bl_C[:lo, :max(nq_cap, 1)], self._bl_C[hi:, :max(nq_cap, 1)]], 0
        )
        self._bl_Bf_cap = np.concatenate(
            [self._bl_Bf[:lo], self._bl_Bf[hi:]], 0
        )

        # --- banded cap convolution (ring_mode="split"): partition the cap
        # rings by length and run each band's Bluestein at its own (smaller)
        # conv size, with the m axis truncated to the band's Legendre
        # support — λ_ℓm(θ) decays super-exponentially for
        # m > ℓ·sinθ + O((ℓ·sinθ)^{1/3}), so G[r, m] from the Legendre
        # stage is numerically zero there (bound verified against the
        # production Λ tables at nside=512: ≥ 46 columns of slack at
        # ε=1e-8).  Cuts the cap FFT work
        # ~2× at nside=512 (the pole-most half of the rows runs at ≤ 1/4
        # the conv size).
        self._cap_bands = None
        if cap_bands is None:
            cap_bands = 5 if lo >= 64 else 0
        if cap_bands and lo >= 16 and self._eq_lo > 0:
            edges = sorted(
                {int(round(lo * f)) for f in
                 [i / cap_bands for i in range(1, cap_bands + 1)]} | {lo}
            )
            edges = [0] + [e for e in edges if e > 0]
            bands = []
            for b in range(len(edges) - 1):
                i0, i1 = edges[b], edges[b + 1]
                q_b = int(self._nq[i1 - 1])  # largest ring in band
                sth = float(self._sth_half[i1 - 1])
                x = lmax * sth
                M_b = int(min(L, np.ceil(x + 12.0 * max(x, 1.0) ** (1 / 3.0)
                                         + 40.0)))
                D_b = max(M_b, q_b) - 1
                n_b = _next_conv_size(2 * D_b + 1)
                bands.append(dict(i0=i0, i1=i1, M=M_b, q=q_b, n=n_b))
            # merge adjacent bands that landed on the same conv size (no
            # gain from splitting them; fewer, larger matmuls win)
            merged = [bands[0]]
            for bd in bands[1:]:
                if bd["n"] == merged[-1]["n"] and bd["M"] == merged[-1]["M"]:
                    merged[-1] = dict(
                        i0=merged[-1]["i0"], i1=bd["i1"],
                        M=bd["M"], q=bd["q"], n=bd["n"],
                    )
                else:
                    merged.append(bd)
            # host tables per band: chirp rows are slices of the full-ring
            # tables; the conv kernel is rebuilt at the band size
            self._cap_band_tabs = []
            self._cap_band_ffts = {}
            for bd in merged:
                i0, i1, M_b, q_b, n_b = (
                    bd["i0"], bd["i1"], bd["M"], bd["q"], bd["n"]
                )
                rn = np.arange(i0, i1)  # north ring rows (global = local)
                rs = np.arange(nring - i1, nring - i0)  # south rings asc.
                rows = np.concatenate([rn, rs])
                A_b = self._bl_A[rows][:, :M_b]
                C_b = self._bl_C[rows][:, :q_b]
                D_b = max(M_b, q_b) - 1
                c2 = np.zeros((rows.size, n_b), dtype=np.complex128)
                for k, r in enumerate(rows):
                    nr = int(self._nq[r])
                    dpos = np.arange(D_b + 1)
                    w = np.exp(
                        -1j * np.pi
                        * np.mod(dpos.astype(np.int64) ** 2, 2 * nr) / nr
                    )
                    c2[k, : D_b + 1] = w
                    c2[k, n_b - D_b:] += w[1:][::-1]
                Bf_b = np.fft.fft(c2, axis=-1)
                self._cap_band_tabs.append((A_b, C_b, Bf_b))
                if n_b not in self._cap_band_ffts:
                    self._cap_band_ffts[n_b] = fftmm.dft_tables(
                        n_b, dtype=np.complex128
                    )
            self._cap_bands = tuple(
                (bd["i0"], bd["i1"], bd["M"], bd["q"], bd["n"])
                for bd in merged
            )

        r_of_pix = np.repeat(np.arange(nring), self._nq)
        self._r_of_pix = r_of_pix.astype(np.int32)
        self._j_of_pix = (np.arange(self.npix) - self._start[r_of_pix]).astype(
            np.int32
        )

        self._mirror = np.minimum(
            np.arange(nring), nring - 1 - np.arange(nring)
        ).astype(np.int32)
        self._north_idx = np.minimum(np.arange(nring), nh - 1).astype(np.int32)
        self._south_idx = self._mirror[nh:]

        # Every ring table (chirps, conv kernels, phases) is a function of
        # (n_r, phi0_r) alone, built by identical float expressions — so a
        # palindromic geometry makes mirror rows BITWISE equal, and the
        # parity ring synthesis (_rings_to_grid_parity: transforms on the
        # half-size even/odd accumulators, N/S mirror as an output add/sub)
        # is exact.  True for HEALPix; asserted, not assumed.
        self._ns_symmetric = bool(
            np.array_equal(self._nq, self._nq[::-1])
            and np.array_equal(self._phi0, self._phi0[::-1])
        )

        self._lam_meta = self._lambda_chunk_meta()
        # "host": exact f64 host recurrence → f32 chunks (accuracy
        # reference, ~2e-7 map RMS; minutes of host build + a multi-GB
        # transfer at large Nside).  "device": chunks materialised on the
        # accelerator by the scaled+checkpointed recurrence
        # (_build_lambda_device) — seconds of setup, scan-mode accuracy
        # class (~1e-6 map RMS, within the 1e-5 contract).
        if lambda_build not in ("host", "device"):
            raise ValueError(f"unknown lambda_build {lambda_build!r}")
        self.lambda_build = lambda_build
        self._lam_host = None
        if legendre_mode == "cached" and lambda_build == "host":
            self._lam_host = self._load_or_build_lambda(lambda_cache)
        self.scan_ckpt = bool(scan_ckpt)
        # re-seed every ckpt_every-th ℓ-chunk only (table is 1/ckpt_every
        # the size; error grows ∝ the effective re-seed spacing).  Both the
        # streamed and the dense lax.scan paths apply it per band.
        self.ckpt_every = max(1, int(ckpt_every))
        self._ck_host = None
        if (legendre_mode == "scan" and scan_ckpt) or (
            legendre_mode == "cached" and lambda_build == "device"
        ):
            self._ck_host = self._load_or_build_checkpoints(ckpt_cache)

        # device table cache per precision
        self._dev_tables = {}

    # static hashability: jit caches per instance
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    # ------------------------------------------------------------------

    def _load_or_build_lambda(self, cache_path):
        """Λ weight chunks, loaded from an on-disk cache when available.

        The float64 recurrence is the dominant host setup cost at large
        Nside (~2 min at Nside=512); the chunks are pure functions of
        (nside, lmax, l_chunk, cache_dtype) so they are safe to persist —
        the transform's "weights checkpoint".
        """
        import os

        if cache_path:
            meta = np.array(
                [self.nside, self.lmax, self.l_chunk, 2], dtype=np.int64
            )  # last entry: Λ layout version (2 = parity-packed)
            if os.path.exists(cache_path):
                try:
                    d = np.load(cache_path)
                    if np.array_equal(d["meta"], meta) and str(
                        d["dtype"]
                    ) == np.dtype(self.cache_dtype).name:
                        n = int(d["n"])
                        return [d[f"lam{i}"] for i in range(n)]
                except Exception:
                    pass
            lam = self._build_lambda_cache()
            try:
                np.savez(
                    cache_path,
                    meta=meta,
                    dtype=np.dtype(self.cache_dtype).name,
                    n=len(lam),
                    **{f"lam{i}": c for i, c in enumerate(lam)},
                )
            except Exception:
                pass
            return lam
        return self._build_lambda_cache()

    def _lambda_chunk_meta(self):
        """Chunk layout for the parity-packed Λ cache.

        Chunks cover the even-ℓ subsequence first, then the odd-ℓ one;
        returns [(parity, sub_lo, nrows, mwidth)].  Pure function of
        (lmax, l_chunk) so disk-cached tables can be reused.
        """
        L = self.lmax + 1
        lc = self.l_chunk
        meta = []
        for parity in (0, 1):
            nsub = (L - parity + 1) // 2
            for j in range(-(-nsub // lc)):
                sub_lo = j * lc
                nrows = min(lc, nsub - sub_lo)
                lmax_chunk = parity + 2 * (sub_lo + nrows - 1)
                mwidth = min(L, ((lmax_chunk + 1 + 127) // 128) * 128)
                meta.append((parity, sub_lo, nrows, mwidth))
        return meta

    def _build_scan_checkpoints(self):
        """Exact λ carry rows at ℓ-chunk boundaries (checkpointed scan).

        Returns [nchunk, 2, nh, L] float32: rows (λ_{l0-2}, λ_{l0-1}) for
        each chunk start l0 = c·l_chunk (zeros for c = 0: no override).
        Injecting these exact f64-built rows restarts the in-graph f32
        recurrence every l_chunk steps, cutting its coherent near-pole
        error growth from O(lmax·ε) to O(l_chunk·ε) — map RMS ~1e-6 vs
        ~2e-5 for the plain scaled scan at nside=256.  Memory is
        2·nchunk·nh·L·4 B (~300 MB at nside=512/l_chunk=64) — the ~1/l_chunk
        slice of the full Λ table that accuracy actually needs.

        The recurrence is independent per ring, so blocks of rings run on
        a thread pool (numpy releases the GIL in the row updates): the
        O(nh·L²) build takes minutes single-threaded at nside 1024.
        """
        import os
        from concurrent.futures import ThreadPoolExecutor

        L = self.lmax + 1
        nh = self.nhalf
        lc = self.l_chunk
        ke = self.ckpt_every
        nchunk = -(-L // lc)
        n_ck = -(-nchunk // ke)
        rec_a = self._rec_a
        rec_b = self._rec_b
        ck = np.zeros((n_ck, 2, nh, L), dtype=np.float32)

        def build(rs):
            z = self._z_half[rs, None]

            def step(l, sl, lam_p, out):
                out[:, sl] *= rec_b[l, sl]
                out[:, sl] += rec_a[l, sl] * z * lam_p[:, sl]

            lam_prev = None
            for ll, lam, k in _host_scaled_rows(
                self._log2_lam_mm[rs], self._lam_sign, np.arange(L), step
            ):
                nxt = ll + 1
                if (nxt + 1) % (lc * ke) == 0 and (nxt + 1) // lc < nchunk:
                    lam_prev = np.where(k == 0, lam, 0.0)
                if nxt % (lc * ke) == 0 and nxt // lc < nchunk:
                    c = nxt // (lc * ke)
                    ck[c, 0, rs] = lam_prev
                    ck[c, 1, rs] = np.where(k == 0, lam, 0.0)

        nthreads = max(1, min(len(os.sched_getaffinity(0)), nh // 64))
        per = -(-nh // nthreads)
        blocks = [slice(i, min(i + per, nh)) for i in range(0, nh, per)]
        with ThreadPoolExecutor(len(blocks)) as ex:
            list(ex.map(build, blocks))
        return ck

    def _load_or_build_checkpoints(self, cache_path):
        """Scan checkpoints, disk-cached like the Λ chunks."""
        import os

        if cache_path:
            meta = np.array([self.nside, self.lmax, self.l_chunk,
                             self.ckpt_every], dtype=np.int64)
            if os.path.exists(cache_path):
                try:
                    d = np.load(cache_path)
                    if np.array_equal(d["meta"], meta):
                        return d["ck"]
                except Exception:
                    pass
            ck = self._build_scan_checkpoints()
            try:
                np.savez(cache_path, meta=meta, ck=ck)
            except Exception:
                pass
            return ck
        return self._build_scan_checkpoints()

    def _build_lambda_cache(self):
        """Host float64 recurrence → float32 ragged parity-packed Λ chunks.

        Each chunk holds λ_ℓm for ℓ of ONE parity (see _lambda_chunk_meta)
        over the northern rings: [nrows, nh, M_c].  Pure-parity chunks let
        the contraction run un-masked einsums at half the FLOPs (the
        (ℓ+m)-parity decision moves to cheap m-masks on the outputs).
        Total ≈ nh·lmax²/2·4 bytes (~5 GB at nside=512) — the transform's
        "weights".
        """
        L = self.lmax + 1
        nh = self.nhalf

        z = self._z_half
        lam_mm = self._lam_mm
        rec_a = self._rec_a
        rec_b = self._rec_b

        lam_p = np.zeros((nh, L))
        lam_pp = np.zeros((nh, L))
        m_arr = np.arange(L)

        meta = self._lambda_chunk_meta()
        # rows by global ell, written as the recurrence advances
        bufs = [
            np.zeros((nrows, nh, mw), dtype=self.cache_dtype)
            for (_, _, nrows, mw) in meta
        ]
        # map global ell -> (chunk index, row within chunk)
        where = {}
        for ci, (parity, sub_lo, nrows, mw) in enumerate(meta):
            for i in range(nrows):
                where[parity + 2 * (sub_lo + i)] = (ci, i)

        az = np.empty((nh, L))
        with np.errstate(under="ignore"):
            for ll in range(L):
                # triangle in-place update (see _build_scan_checkpoints)
                sl = slice(0, ll + 1)
                lam = lam_pp
                np.multiply(z[:, None], lam_p[:, sl], out=az[:, sl])
                az[:, sl] *= rec_a[ll, sl][None, :]
                lam[:, sl] *= rec_b[ll, sl][None, :]
                lam[:, sl] += az[:, sl]
                lam[:, ll] = lam_mm[:, ll]
                lam_pp = lam_p
                lam_p = lam
                ci, i = where[ll]
                bufs[ci][i] = lam[:, : bufs[ci].shape[-1]]
        return bufs

    def tables(self, double: bool = False):
        """Device table pytree at the requested precision (cached).

        The cache is keyed by the current placement device as well: under
        a ``jax.default_device`` context (e.g. util.compute.model_device)
        the tables commit to that device, and reusing them later under a
        different placement would silently pin the whole transform to the
        wrong backend (or crash on mixed-device inputs).
        """
        key = (bool(double), str(jax.config.jax_default_device))
        if key in self._dev_tables:
            return self._dev_tables[key]

        cdt = np.complex128 if double else np.complex64
        fdt = np.float64 if double else np.float32

        # Device Λ build runs OUTSIDE ensure_compile_time_eval: under that
        # context its jit would be constant-folded op-by-op and the
        # multi-GB chunks would be captured as lowering constants.  Here
        # it executes as one real jitted program with device-array inputs.
        lam_dev = None
        if self.legendre_mode == "cached" and self._lam_host is None:
            with _stage("lambda_device_build"):
                lam_dev = _build_lambda_device(self, fdt)

        # Build eagerly even if called during a trace — cached device
        # buffers must be concrete arrays, not trace-local constants.
        with jax.ensure_compile_time_eval():
            t = self._make_tables(cdt, fdt, lam_dev)

        self._dev_tables[key] = t
        return t

    def _make_tables(self, cdt, fdt, lam_dev=None):
        put = jax.device_put
        fused = self.fft_mode == "mm" and self.conv_mode == "fused"

        def put_kernel(key, K, n1n2):
            # conv kernels ship in exactly the layout the active conv form
            # consumes — permuted [k1, k2] spectrum order for "fused"
            # (fftmm.permute_kernel), flat frequency order otherwise.
            # Only one variant is stored (they are the same bytes
            # re-ordered; storing both would double the kernel memory).
            if fused:
                t[key + "P"] = put(fftmm.permute_kernel(K.astype(cdt), *n1n2))
            else:
                t[key] = put(K.astype(cdt))

        t = dict(
            chirp_A=put(self._chirp_A.astype(cdt)),
            fold_phase=put(self._fold_phase.astype(cdt)),
            fold_idx=put(self._fold_idx),
            r_of_pix=put(self._r_of_pix),
            j_of_pix=put(self._j_of_pix),
            mirror=put(self._mirror),
            north_idx=put(self._north_idx),
            south_idx=put(self._south_idx),
        )
        put_kernel("chirp_Bf", self._chirp_Bf, self._fft_n1n2)
        if self.fft_mode == "mm":
            for key, tab in [("fft", "fwd"), ("ifft", "inv")]:
                for nm in ("W1", "T", "W2"):
                    t[key + nm] = put(self._fftmm_tabs[tab][nm].astype(cdt))
        t["bl_A"] = put(self._bl_A.astype(cdt))
        t["bl_C"] = put(self._bl_C.astype(cdt))
        put_kernel("bl_Bf", self._bl_Bf, self._fft2_n1n2)
        if self.ring_mode == "split":
            t["eq_phase"] = put(self._eq_phase.astype(cdt))
            t["bl_A_cap"] = put(self._bl_A_cap.astype(cdt))
            t["bl_C_cap"] = put(self._bl_C_cap.astype(cdt))
            put_kernel("bl_Bf_cap", self._bl_Bf_cap, self._fft2_n1n2)
            if self._cap_bands is not None:
                for b, (A_b, C_b, Bf_b) in enumerate(self._cap_band_tabs):
                    n_b = self._cap_bands[b][4]
                    t[f"bl_A_cb{b}"] = put(A_b.astype(cdt))
                    t[f"bl_C_cb{b}"] = put(C_b.astype(cdt))
                    put_kernel(
                        f"bl_Bf_cb{b}", Bf_b,
                        self._cap_band_ffts[n_b]["n1n2"],
                    )
                for n_b, tabs_b in self._cap_band_ffts.items():
                    for key, tab in [("fftB", "fwd"), ("ifftB", "inv")]:
                        for nm in ("W1", "T", "W2"):
                            t[f"{key}{n_b}{nm}"] = put(
                                tabs_b[tab][nm].astype(cdt)
                            )
            for key, tab in [("fftW", "fwd"), ("ifftW", "inv")]:
                for nm in ("W1", "T", "W2"):
                    t[key + nm] = put(self._fftmmW_tabs[tab][nm].astype(cdt))
            for nm in ("W1", "T", "W2"):
                t["ifftW2" + nm] = put(self._fftmmW2_tabs["inv"][nm].astype(cdt))
            t["eq_twid"] = put(self._eq_twid.astype(cdt))
        for key, tab in [("fft2", "fwd"), ("ifft2", "inv")]:
            for nm in ("W1", "T", "W2"):
                t[key + nm] = put(self._fftmm2_tabs[tab][nm].astype(cdt))
        if self._lam_host is not None:
            # device layout [mw, nrows, nh] (m-major, rings minor): matches
            # the layout XLA assigns the contraction operand, so the chunks
            # are consumed in place — the row-major [nrows, nh, mw] form
            # gets copied (~Λ-sized HLO temps) inside every sweep
            t["lam"] = tuple(
                put(np.ascontiguousarray(
                    c_.astype(self.cache_dtype).transpose(2, 0, 1)
                ))
                for c_ in self._lam_host
            )
        elif self.legendre_mode == "cached":  # lambda_build == "device"
            t["lam"] = lam_dev
        else:
            S, beta = _lam_scale_params(fdt)
            log2lam = self._log2_lam_mm
            k0 = np.ceil(np.maximum(0.0, -(log2lam + beta) / S))
            with np.errstate(under="ignore"):
                seeds = self._lam_sign * np.exp2(log2lam + S * k0)
            t["rec_a"] = put(self._rec_a.astype(fdt))
            t["rec_b"] = put(self._rec_b.astype(fdt))
            t["lam_mm"] = put(seeds.astype(fdt))
            t["lam_k0"] = put(k0.astype(fdt))
            t["z_half"] = put(self._z_half.astype(fdt))
            if self._ck_host is not None and fdt == np.float32:
                # f32 only: overriding an exact f64 recurrence with
                # f32-cast rows would degrade the double path
                t["lam_ck"] = put(self._ck_host)
        return t

    @staticmethod
    def _double_for(dtype):
        return dtype in (jnp.complex128, jnp.float64) or np.dtype(dtype) in (
            np.dtype(np.complex128),
            np.dtype(np.float64),
        )

    # ------------------------------------------------------------------
    # Public transforms
    # ------------------------------------------------------------------

    def synthesis(self, alm):
        """alm2map: dense alm[..., lmax+1, lmax+1] → map[..., 12 nside²]."""
        alm = _put(alm)
        t = self.tables(self._double_for(alm.dtype))
        return _synthesis_jit(self, t, alm)

    def analysis(self, fmap, iter: int = 3, method: str = "jacobi"):
        """map2alm with pixel-area quadrature + iterative refinement.

        method="jacobi" (default) matches healpy's map2alm(iter=N)
        accuracy class; method="cg" solves the quadrature normal
        equations by conjugate gradients — machine-precision round trips
        for band-limited maps (lmax ≤ 2·nside) at the same per-iteration
        cost (accuracy table in BASELINE.md)."""
        fmap = _put(fmap)
        t = self.tables(self._double_for(fmap.dtype))
        if method == "cg":
            return _analysis_cg_jit(self, t, fmap, iter)
        return _analysis_jit(self, t, fmap, iter)

    def synthesis_grid(self, alm):
        """alm2map onto the dense [nring, nq_max] ring grid (device-safe).

        This is the accelerator production layout: no scatter/gather ops.  Use
        grid_to_map / map_to_grid to convert to HEALPix pixel ordering.
        """
        alm = _put(alm)
        t = self.tables(self._double_for(alm.dtype))
        return _synthesis_grid_jit(self, t, alm)

    def analysis_grid(self, fgrid, iter: int = 3, method: str = "jacobi"):
        """map2alm from the dense ring-grid layout.

        method="cg" solves the quadrature normal equations by conjugate
        gradients — ~2× lower error than Jacobi at equal iteration count
        (each iteration costs one synthesis + one adjoint in both).
        """
        fgrid = _put(fgrid)
        t = self.tables(self._double_for(fgrid.dtype))
        if method == "cg":
            return _analysis_cg_grid_jit(self, t, fgrid, iter)
        return _analysis_grid_jit(self, t, fgrid, iter)

    def grid_to_map(self, fgrid):
        """Ring-grid -> HEALPix RING pixel ordering (native host path)."""
        from .. import native

        fgrid = np.asarray(fgrid)
        return native.grid_to_pixels(fgrid, self._start, self._nq, self.npix)

    def map_to_grid(self, fmap):
        """HEALPix RING pixel ordering -> ring-grid (native host path)."""
        from .. import native

        fmap = np.asarray(fmap)
        nq_max = self._bl_C.shape[-1]
        return native.pixels_to_grid(fmap, self._start, self._nq, nq_max)

    # --- internal traced hooks (used by the spin module and tests) ---

    def _legendre_contract(self, alm):
        t = self.tables(self._double_for(alm.dtype))
        if "lam" in t:
            return _legendre_contract_cached(self, t, alm)
        return _legendre_contract_scan(self, t, alm)

    def _legendre_project(self, G):
        t = self.tables(self._double_for(G.dtype))
        if "lam" in t:
            return _legendre_project_cached(self, t, G)
        return _legendre_project_scan(self, t, G)

    def _rings_to_complex(self, G):
        t = self.tables(self._double_for(G.dtype))
        return _rings_to_complex(self, t, G)

    def _map_to_rings(self, fmap, dtype=jnp.complex128):
        t = self.tables(self._double_for(dtype))
        return _map_to_rings(self, t, fmap, dtype)


def get_sht(
    nside: int, lmax: int, l_chunk: int = 64, legendre_mode=None,
    fft_mode="xla", lambda_build=None,
) -> SHT:
    """Cached SHT operator.

    Defaults: "cached" Legendre on accelerators ("scan" on CPU, where the
    f64 scan is the exact reference), ring FFTs through ``jnp.fft``
    (cuFFT on the GPU: it beat the matmul FFTs of ``fft_mode="mm"`` on the
    flagship step and holds the same accuracy, PERF.md).
    The cached Λ table grows as nside·lmax² (4.8 GB at nside 512, 38 GB
    at 1024), so above nside=512 accelerators switch to the Λ-free
    checkpointed scan.  On accelerators the cached Λ chunks are
    materialised on device by default (lambda_build="device": seconds of
    setup instead of a minutes-long host f64 build + multi-GB transfer;
    scan-accuracy class, within the 1e-5 map contract — pass
    lambda_build="host" for the exact f64-built reference tables).

    Placement-aware: under a CPU ``jax.default_device`` context (e.g.
    util.compute.model_device inside a GPU process) the CPU defaults
    apply, and a separate operator is cached for that placement.
    """
    dd = jax.config.jax_default_device
    on_cpu = jax.default_backend() == "cpu" or (
        dd is not None and getattr(dd, "platform", None) == "cpu"
    )
    big = nside > 512
    if legendre_mode is None:
        legendre_mode = "scan" if (on_cpu or big) else "cached"
    if lambda_build is None:
        lambda_build = "host" if on_cpu else "device"
    return _get_sht_cached(
        nside, lmax, l_chunk, legendre_mode, fft_mode, lambda_build,
        on_cpu,
    )


@lru_cache(maxsize=8)
def _get_sht_cached(nside, lmax, l_chunk, legendre_mode, fft_mode,
                    lambda_build, on_cpu):
    cdir = _user_cache_dir()
    # re-seed cadence: keeps the checkpoint table (nh·L²/(l_chunk·ke)
    # floats) at its nside=512 size as nside grows
    ke = max(1, (nside // 512) ** 2)
    return SHT(
        nside, lmax, l_chunk=l_chunk, legendre_mode=legendre_mode,
        fft_mode=fft_mode, scan_ckpt=legendre_mode == "scan" and not on_cpu,
        lambda_build=lambda_build,
        lambda_cache=cdir and f"{cdir}/lam_{nside}_{lmax}_{l_chunk}.npz",
        ckpt_cache=cdir and f"{cdir}/ck_{nside}_{lmax}_{l_chunk}_{ke}.npz",
        # keep the checkpoint table bounded as lmax grows (it scales as
        # nh·L²/(l_chunk·ckpt_every))
        ckpt_every=ke,
    )


def _user_cache_dir():
    """Table-cache dir: $CORA_TPU_CACHE, else ``<checkout>/.table_cache``;
    None (in-memory only) if unwritable or CORA_TPU_CACHE="".  Λ chunks and scan checkpoints
    are pure functions of (nside, lmax, l_chunk[, ckpt_every]), so caching
    them across processes is safe — they are the transform's "weights"."""
    import os

    d = os.environ.get("CORA_TPU_CACHE")
    if d == "":
        return None
    if d is None:
        from ..util.compute import CHECKOUT

        d = os.path.join(CHECKOUT, ".table_cache")
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def alm2map(alm, nside: int):
    """Synthesis of a dense alm[..., l, m] array onto a HEALPix map."""
    alm = _put(alm)
    lmax = alm.shape[-2] - 1
    return get_sht(nside, lmax).synthesis(alm)


def map2alm(fmap, lmax: int | None = None, iter: int = 3,
            method: str = "jacobi", solve_lmax: int | None = None):
    """Analysis of a HEALPix map into dense alm[..., l, m].

    method="cg" upgrades the refinement to conjugate gradients (see
    SHT.analysis); the default matches healpy's map2alm(iter=N) class.

    solve_lmax — two-stage banded solve for full-lmax output.  The
    HEALPix grid determines alm uniquely only to ℓ ≲ 2·nside: at
    lmax = 3·nside−1 the per-m normal blocks reach cond ~1e26 (ring-
    Nyquist information loss, identical in f64 — measured in
    tools/pinv_analysis_proto.py), and solving the full-lmax system
    pollutes even the well-determined band (band error 1.7e-3 in f32
    AND 1.4e-3 in f64 at nside=64).  With ``solve_lmax`` (recommended
    2·nside) the band is solved by CG on its own well-conditioned
    system — f32 reaches ~6e-7, f64 ~3e-15 — and rows above it are
    completed by one quadrature projection of the residual (they are
    information-limited on this grid in any precision; same contract
    as the reference's healpy quadrature, cora/util/hputil.py:46-47).
    """
    fmap = _put(fmap)
    nside = pixel.npix2nside(fmap.shape[-1])
    if lmax is None:
        lmax = 3 * nside - 1
    if solve_lmax is None or solve_lmax >= lmax:
        return get_sht(nside, lmax).analysis(fmap, iter, method=method)

    op_b = get_sht(nside, int(solve_lmax))
    alm_b = op_b.analysis(fmap, iter, method="cg")
    resid = fmap - op_b.synthesis(alm_b)
    # corner completion: plain quadrature projection of the residual
    alm_f = get_sht(nside, lmax).analysis(resid, 0)
    pad = [(0, 0)] * (alm_b.ndim - 2) + [
        (0, lmax - solve_lmax), (0, lmax - solve_lmax)
    ]
    out = jnp.pad(alm_b, pad)
    keep = jnp.arange(lmax + 1)[:, None] > solve_lmax
    return out + jnp.where(keep, alm_f, 0.0)


def anafast(map1, map2=None, lmax: int | None = None, iter: int = 3,
            method: str = "jacobi", solve_lmax: int | None = None):
    """Angular power spectrum C_l of one map or cross-spectrum of two."""
    nside = pixel.npix2nside(np.asarray(map1).shape[-1])
    if lmax is None:
        lmax = 3 * nside - 1
    alm1 = map2alm(map1, lmax, iter, method, solve_lmax)
    alm2 = alm1 if map2 is None else map2alm(map2, lmax, iter, method,
                                             solve_lmax)
    prod = alm1 * jnp.conj(alm2)
    s = prod[..., 0] + 2 * prod[..., 1:].sum(axis=-1).real
    return (s / (2.0 * jnp.arange(lmax + 1) + 1.0)).real


def alm2map_der1(alm, nside: int):
    """Map and its first derivatives [f, df/dθ, df/dφ/sinθ].

    healpy.alm2map_der1 equivalent; the angular derivatives are one
    batched spin-1 synthesis.
    """
    from . import spin as _spin

    alm = _put(alm)
    lmax = alm.shape[-2] - 1
    f = alm2map(alm, nside)

    ell = jnp.arange(lmax + 1)[:, None]
    almE = alm * jnp.sqrt(ell * (ell + 1.0))
    op = _spin.get_spin_sht(nside, lmax, 1)
    # Our spin-1 B-component convention is the negative of healpy's
    # dφ/sinθ (verified against analytic Y_11/Y_10 derivatives).
    dth, dph = op.synthesis(-almE, jnp.zeros_like(almE))
    return jnp.stack([f, dth, -dph])


def smoothalm(alm, fwhm: float):
    """Gaussian beam smoothing of alm (fwhm in radians)."""
    lmax = alm.shape[-2] - 1
    l = jnp.arange(lmax + 1)
    sigma_b = fwhm / np.sqrt(8.0 * np.log(2.0))
    bl = jnp.exp(-0.5 * l * (l + 1) * sigma_b**2)
    return alm * bl[:, None]


def smoothing(fmap, fwhm: float = None, iter: int = 3, sigma: float = None):
    """Gaussian beam smoothing of a map (healpy.smoothing equivalent)."""
    if fwhm is None:
        fwhm = sigma * np.sqrt(8.0 * np.log(2.0))
    nside = pixel.npix2nside(np.asarray(fmap).shape[-1])
    lmax = 3 * nside - 1
    alm = map2alm(_put(fmap), lmax, iter)
    return alm2map(smoothalm(alm, fwhm), nside)


def smoothing_grid(fmap, fwhm: float = None, iter: int = 3,
                   sigma: float = None, lmax: int | None = None):
    """Gaussian beam smoothing in the dense ring-grid layout.

    Same math as :func:`smoothing` but (a) the transforms run in the
    dense ring-grid layout (the pixel reordering runs in the native host
    library) and (b) by default the analysis band is BEAM-LIMITED: the
    Gaussian beam is < 4e-6 of peak beyond ℓ = 5/σ, so wide-beam
    smoothing of a high-nside map costs a tiny transform instead of a
    full-lmax one.  Caveat of the default: map power ABOVE the analysis
    band aliases into the fit (≈2-3% for white-spectrum inputs at small
    nside) — fine for red-spectrum sky maps, where the out-of-band power
    is negligible; pass ``lmax=3·nside−1`` for healpy-equivalent
    behaviour on arbitrary inputs.  Accepts a single map or a leading
    batch axis; returns float numpy.
    """
    from .. import native
    from ..util.xfer import get as _get

    if fwhm is None:
        fwhm = sigma * np.sqrt(8.0 * np.log(2.0))
    sig = fwhm / np.sqrt(8.0 * np.log(2.0))
    fmap = np.asarray(fmap, dtype=np.float32)
    nside = pixel.npix2nside(fmap.shape[-1])
    if lmax is None:
        lmax = min(3 * nside - 1, max(64, int(np.ceil(5.0 / max(sig, 1e-12)))))

    info = pixel.ring_info(nside)
    nring = info["nphi"].size
    W = int(info["nphi"].max())
    r_of = np.repeat(np.arange(nring), info["nphi"])
    j_of = np.arange(fmap.shape[-1]) - info["start"][r_of]
    grid = np.zeros(fmap.shape[:-1] + (nring, W), dtype=np.float32)
    grid[..., r_of, j_of] = fmap

    la = np.arange(lmax + 1, dtype=np.float64)
    bl = np.exp(-0.5 * la * (la + 1.0) * sig**2).astype(np.float32)

    op = get_sht(nside, lmax)
    alm = op.analysis_grid(_put(grid), iter=iter)
    sm_grid = np.asarray(_get(op.synthesis_grid(alm * _put(bl)[:, None])))
    flat = sm_grid.reshape((-1,) + sm_grid.shape[-2:])
    out = native.grid_to_pixels(
        flat, info["start"].astype(np.int64), info["nphi"].astype(np.int64),
        fmap.shape[-1],
    )
    return out.reshape(fmap.shape)
