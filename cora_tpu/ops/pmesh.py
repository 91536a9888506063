"""Particle-mesh / SPH mass assignment on (radial bin × HEALPix pixel) grids.

JAX replacement for the reference's OpenMP Cython/C kernels
(cora/util/pmesh.pyx + pmesh_util.c): SPH-style Gaussian mass assignment
over the 9 nearest-neighbour pixels and ±1 radial bins, normalised per
particle.  The atomic scatter-add of the C kernel (pmesh_util.c:37-38)
becomes a deterministic XLA scatter-add (`.at[].add`) — no atomics, no
races, identical results run-to-run.

All functions are jittable; the host-compatible wrappers live in
cora_tpu.util.pmesh.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def calculate_positions(angpos, displacement):
    """Apply an angular displacement with pole/azimuth wrapping.

    Parameters
    ----------
    angpos : [2, npix] (theta, phi)
    displacement : [2, npix]

    Returns
    -------
    new_angpos : [2, npix]
    """
    new = angpos + displacement
    th, ph = new[0], new[1]

    wrap = (th > jnp.pi) | (th < 0)
    th = jnp.where(wrap, jnp.pi - th % jnp.pi, th)
    ph = jnp.where(wrap, ph + jnp.pi, ph)
    ph = ph % (2 * jnp.pi)
    return jnp.stack([th, ph])


def pixel_weights(new_ang_ind, new_ang_vec, scaling, sigma, nn_ind, nn_vec,
                  *, nside=None):
    """Gaussian SPH weights over the 9 neighbour pixels of each particle.

    Parameters
    ----------
    new_ang_ind : [npart] int
        Pixel containing each particle's new position.
    new_ang_vec : [npart, 3]
        Particle positions as unit vectors.
    scaling : [npart]
        Particle size scaling (local volume change).
    sigma : float
        Nominal angular particle size.
    nn_ind : [npix, 9] int
        Neighbour pixel indices (self first; -1 where missing).
    nn_vec : [npix, 9, 3] or None
        Neighbour pixel centre vectors.  ``None`` computes them
        arithmetically from the ids (:func:`_pix2vec_jax`; requires
        ``nside``) — removes a 21 M-element-per-slice gather at
        ~4e-7 vector accuracy (table storage class).

    Returns
    -------
    pixel_ind : [npart, 9] int32
    pixel_weight : [npart, 9]
    """
    npix = nn_ind.shape[0]
    ind = jnp.clip(new_ang_ind, 0, npix - 1)

    nbr_i = nn_ind[ind]  # [npart, 9]
    if nn_vec is None:
        nbr_v = _pix2vec_jax(nside, jnp.maximum(nbr_i, 0)).astype(
            new_ang_vec.dtype
        )
    else:
        nbr_v = nn_vec[ind]  # [npart, 9, 3]

    dot = jnp.einsum("pjc,pc->pj", nbr_v, new_ang_vec)
    dist2 = 1.0 - dot * dot  # sin^2 of angular separation

    inv_sigma2 = (scaling * sigma) ** -2
    w = jnp.exp(-0.5 * dist2 * inv_sigma2[:, None])

    valid = nbr_i >= 0
    w = jnp.where(valid, w, 0.0)
    pix = jnp.where(valid, nbr_i, 0).astype(jnp.int32)

    w = w / jnp.sum(w, axis=1, keepdims=True)
    return pix, w


def radial_weights(new_chi_ind, new_chi, scaling, sigma, nnh, chi):
    """Gaussian SPH weights over the ±nnh nearest radial bins.

    The window is clipped so it never extends beyond the radial range
    (edge particles deposit on the interior side).
    """
    nchi = chi.shape[0]
    nn = 2 * nnh + 1

    low = jnp.clip(new_chi_ind - nnh, 0, nchi - nn)
    offs = jnp.arange(nn)
    idx = low[:, None] + offs[None, :]  # [npart, nn]

    dchi = chi[idx] - new_chi[:, None]
    inv_sigma2 = (scaling * sigma) ** -2
    w = jnp.exp(-0.5 * dchi**2 * inv_sigma2[:, None])
    w = w / jnp.sum(w, axis=1, keepdims=True)
    return idx.astype(jnp.int32), w


def bin_delta(rho, pixel_ind, pixel_weight, radial_ind, radial_weight, out):
    """Scatter particle masses onto the (radial, pixel) grid.

    out[r, p] += rho_i * radial_weight[i, r'] * pixel_weight[i, p'] for
    every (radial, pixel) pair in each particle's support.  Deterministic
    XLA scatter-add replaces the reference's OpenMP atomics.
    """
    nchi, npix = out.shape

    # [npart, nrad, npix_w]
    w = (
        rho[:, None, None]
        * radial_weight[:, :, None]
        * pixel_weight[:, None, :]
    )
    flat_idx = (
        radial_ind[:, :, None].astype(jnp.int32) * npix
        + pixel_ind[:, None, :].astype(jnp.int32)
    )
    out_flat = out.reshape(-1)
    out_flat = out_flat.at[flat_idx.reshape(-1)].add(w.reshape(-1))
    return out_flat.reshape(nchi, npix)


def _offset_deposit(geom, nside, ii, density, pix_i, pix_w, rad_i, rad_w,
                    out_pad, R, E, KR0, r0, cap):
    """Scatter-free SPH deposit by ring-locality offset binning.

    An alternative to the XLA scatter-add (the 21M-element deposit
    dominates the ZA step at nside=256 × 64 chi): the deposit is
    reformulated as structured *gathers*: each of the 27
    contributions of a particle is labelled by its geometric offset from
    the particle's ORIGIN pixel — ring offset ρ = r_t − r_s (|ρ| ≤ R),
    scaled intra-ring offset ε = j_t − round-mapped(j_s) (|ε| ≤ E), and
    radial offset kr = rad − ii (|kr| ≤ KR0).  For one (ρ, ε) the
    (source → target) relation is a fixed, invertible-by-candidates
    piece of HEALPix ring geometry, so the deposit becomes, per combo, a
    fused mask-sum over the 9 neighbour slots followed by output-side
    gathers — fully vectorised, no scatter (this is a DIA-format sparse
    transpose exploiting that Zel'dovich displacements are few pixels).

    Contributions outside the window (pole rings r < r0 where ring-length
    ratios break the 2-candidate inverse, large displacements, radial
    jumps) go through an EXACT fallback: compacted to ``cap`` slots via
    nonzero + a small scalar scatter, or — if they ever exceed cap — a
    full dense scatter under ``lax.cond`` (pathological inputs only).

    Lost to the scatter on the earlier accelerator: these DIA diagonals
    are only ~8% dense — each of the 2·(2R+1)(2E+1) candidate blocks
    gathers ALL npix output pixels, moving ~50× more elements than the
    27·npix the scatter touches.  Not measured on the GPU (ROADMAP
    Speed 9).  Exactness verified against the scatter path in
    tests/test_lss.py; kept for
    backends where gathers outrun scatters; production uses
    :func:`_window_deposit`.
    """
    from jax import lax

    npix = pix_i.shape[0]
    nring = 4 * nside - 1
    NE = 2 * E + 1
    NR = 2 * KR0 + 1
    f32 = out_pad.dtype  # value dtype follows the output buffer

    r_of = geom["r_of"]
    j_of = geom["j_of"]
    nqf = geom["nq_f"]          # [nring] float32 ring lengths
    A = geom["A_r"]             # [nring] float32 phi0·n/(2π) ∈ {0, 0.5}
    start_r = geom["start_r"]   # [nring] int32 first flat pixel of ring
    density = density.astype(f32)
    pix_w = pix_w.astype(f32)
    rad_w = rad_w.astype(f32)

    # ---- forward: label each contribution with its offset combo -------
    rs = r_of                       # [npix] source ring (source = grid pos)
    js = j_of.astype(f32)
    ns = nqf[rs]
    As = A[rs]
    p = pix_i                       # [npix, 9] target pixels
    rt = r_of[p]
    jt = j_of[p].astype(f32)
    nt = nqf[rt]
    At = A[rt]
    rho = rt - rs[:, None]
    jm = jnp.round((js + As)[:, None] * (nt / ns[:, None]) - At)
    de = jt - jm
    de = de - nt * jnp.round(de / nt)       # centered mod n_t
    polem_s = jnp.minimum(rs, nring - 1 - rs) >= r0
    polem_t = jnp.minimum(rt, nring - 1 - rt) >= r0
    vp = (
        (jnp.abs(rho) <= R) & (jnp.abs(de) <= E)
        & polem_s[:, None] & polem_t
    )
    kp = jnp.where(
        vp, (rho + R) * NE + (de.astype(jnp.int32) + E), -1
    ).astype(jnp.int8)              # [npix, 9]; NP−1 = (2R+1)(2E+1)−1 < 127

    kr = rad_i - ii + KR0           # [npix, 3]
    vr = (kr >= 0) & (kr < NR)

    wpix = pix_w * density[:, None]
    # radial one-hot accumulation a_rad[s, kr] (NR minor: contiguous rows)
    a_rad = jnp.zeros((npix, NR), f32)
    for k in range(rad_i.shape[1]):
        oh = (kr[:, k][:, None] == jnp.arange(NR)[None, :]).astype(f32)
        a_rad = a_rad + oh * rad_w[:, k][:, None]

    # ---- per-combo gather deposit (fori_loop: the unrolled 2·(2R+1)·NE
    # gather blocks crash the remote compile service at production size) --
    jt_out = j_of.astype(f32)
    nt_out = nqf[r_of]
    At_out = A[r_of]
    pole_t = jnp.minimum(r_of, nring - 1 - r_of) >= r0

    def combo_body(kc, rows):
        rho_v = kc // NE - R
        eps_v = kc % NE - E
        rs2 = r_of - rho_v
        rs2c = jnp.clip(rs2, 0, nring - 1)
        ok_r = (
            (rs2 >= 0) & (rs2 < nring) & pole_t
            & (jnp.minimum(rs2c, nring - 1 - rs2c) >= r0)
        )
        ns2 = nqf[rs2c]
        As2 = A[rs2c]
        st2 = start_r[rs2c]
        v = jnp.where(kp == kc.astype(jnp.int8), wpix, 0.0).sum(axis=1)
        y = jnp.mod(jt_out - eps_v.astype(f32), nt_out)
        jinv = (y + At_out) * (ns2 / nt_out) - As2
        c2 = jnp.floor(jinv + 0.8)

        def cand(rows, c):
            cm = jnp.mod(c, ns2)
            fwd = jnp.mod(
                jnp.round((cm + As2) * (nt_out / ns2) - At_out), nt_out
            )
            okc = ok_r & (fwd == y)
            sidx = jnp.clip(st2 + cm.astype(jnp.int32), 0, npix - 1)
            gv = jnp.where(okc, v[sidx], 0.0)
            return rows + gv[None, :] * a_rad[sidx].T

        return cand(cand(rows, c2 - 1.0), c2)

    rows = lax.fori_loop(
        0, (2 * R + 1) * NE, combo_body, jnp.zeros((NR, npix), f32)
    )
    cur = lax.dynamic_slice(out_pad, (ii, 0), (NR, npix))
    out_pad = lax.dynamic_update_slice(out_pad, cur + rows, (ii, 0))

    # ---- exact fallback for out-of-window contributions ----------------
    miss27 = ~(vr[:, :, None] & vp[:, None, :])          # [npix, 3, 9]
    w27 = (
        density[:, None, None]
        * rad_w[:, :, None]
        * pix_w[:, None, :]
    )
    wmiss = jnp.where(miss27, w27, 0.0).reshape(-1)
    tgt = (
        (rad_i[:, :, None] + KR0) * npix + pix_i[:, None, :]
    ).reshape(-1)
    flatm = miss27.reshape(-1)
    nmiss = flatm.sum()

    def compact(o):
        idx = jnp.nonzero(flatm, size=cap, fill_value=0)[0]
        ok = jnp.arange(cap) < nmiss
        return o.at[jnp.where(ok, tgt[idx], 0)].add(
            jnp.where(ok, wmiss[idx], 0.0)
        )

    def dense(o):
        return o.at[tgt].add(wmiss)

    out_flat = lax.cond(nmiss <= cap, compact, dense, out_pad.reshape(-1))
    return out_flat.reshape(out_pad.shape)


def _window_deposit(ii, density, pix_i, pix_w, rad_i, rad_w, out_pad,
                    KR0, cap):
    """Scatter-add deposit into a small per-slice radial window.

    Motivation: a scatter into a small target can run faster than one
    into the full-cube buffer, so the 21M-update deposit lands in a
    [2·KR0+1, npix] window around the source slice that is then added
    into the padded output with one dynamic slice; radial outliers
    (particles displaced beyond ±KR0 bins) go through an exact compacted
    fallback.

    No end-to-end win on the earlier accelerator: the per-slice fallback
    bookkeeping (cumsum compaction + its own small scatters) ate the
    buffer-locality gain.  Not measured on the GPU (ROADMAP Speed 9);
    verified exact (tests/test_lss.py).
    """
    from jax import lax

    npix = pix_i.shape[0]
    NR = 2 * KR0 + 1

    kr = rad_i - ii + KR0                          # [npix, 3]
    vr = (kr >= 0) & (kr < NR)
    wrad = jnp.where(vr, rad_w, 0.0)               # outliers → fallback
    w27 = density[:, None, None] * wrad[:, :, None] * pix_w[:, None, :]
    tloc = jnp.clip(kr, 0, NR - 1)[:, :, None] * npix + pix_i[:, None, :]
    loc = jnp.zeros((NR * npix,), out_pad.dtype)
    loc = loc.at[tloc.reshape(-1)].add(w27.reshape(-1))
    cur = lax.dynamic_slice(out_pad, (ii, 0), (NR, npix))
    out_pad = lax.dynamic_update_slice(
        out_pad, cur + loc.reshape(NR, npix), (ii, 0)
    )

    # Exact fallback for radial outliers, compacted at PARTICLE
    # granularity (a particle's 3 radial slots share its chi index, so
    # outliers cluster by particle).  Compaction is cumsum + scatter-set:
    # jnp.nonzero(size=...) hides a sort, and
    # guarding a dense-scatter branch with lax.cond does NOT help — XLA
    # executes both branches (select conversion), re-paying the full
    # 21M-update scatter.  If misses ever exceed the capacity the deposit
    # POISONS the output with NaN rather than silently dropping mass —
    # raise ``cap`` (or use deposit="scatter") for fields whose radial
    # displacements exceed the ±KR0-bin window on many particles.
    pmiss = ~vr.all(axis=1)                         # [npix] any slot out
    capP = max(1, cap // 27)
    pos = jnp.cumsum(pmiss.astype(jnp.int32)) - 1
    nmiss = pos[-1] + 1

    o = out_pad.reshape(-1)
    # slot→particle map; non-misses land in the discarded dump slot
    slot = jnp.where(pmiss & (pos < capP), pos, capP)
    comp = jnp.full((capP + 1,), -1, jnp.int32)
    comp = comp.at[slot].set(jnp.arange(npix, dtype=jnp.int32))[:capP]
    ok = comp >= 0
    pi = jnp.maximum(comp, 0)
    wr = jnp.where(vr[pi], 0.0, rad_w[pi])          # only missed slots
    amp = density[pi][:, None] * wr * ok[:, None]   # [capP, 3]
    amp = jnp.where(nmiss <= capP, amp, jnp.nan)    # overflow → poison
    vals = amp[:, :, None] * pix_w[pi][:, None, :]  # [capP, 3, 9]
    tg = jnp.where(
        ok[:, None, None],
        (rad_i[pi] + KR0)[:, :, None] * npix + pix_i[pi][:, None, :],
        0,
    )
    o = o.at[tg.reshape(-1)].add(vals.reshape(-1))
    return o.reshape(out_pad.shape)


def _stencil_deposit(ii, density, pix_i, pix_w, rad_i, rad_w, out_pad,
                     nside, DR, DJ, KR):
    """Scatter-free BELT deposit: static masked stencil shifts.

    The equatorial belt (rings nside−1 … 3nside−1, 0-based; ~⅔ of the
    pixels) has CONSTANT ring length W = 4·nside, so a belt pixel id is
    an affine function of its (ring, φ-index) — target offsets
    (Δring, Δφ) are computed arithmetically from the pixel ids (no
    gathers), take only a handful of values for Zel'dovich-scale
    displacements, and the whole deposit factorises into
    (2DR+1)(2DJ+1)(2KR+1) masked `jnp.roll` adds on the [nring_belt, W]
    plane — pure VPU streaming, ZERO scatter (the φ roll is circular,
    matching the ring wrap exactly).  Cap-source particles and the DR
    belt-margin rings go through the plain scatter (two static
    contiguous pixel ranges); belt updates outside the stencil ranges
    POISON the output with NaN (the sharded-deposit contract) rather
    than silently dropping mass — widen DR/DJ/KR for wilder fields.

    Replaces ~⅔ of the reference's atomic scatter volume
    (pmesh_util.c:37-38) with dense shifts.
    """
    from jax import lax

    npix = pix_i.shape[0]
    W = 4 * nside
    nbr = 2 * nside + 1                    # belt ring count
    S_belt = 2 * nside * (nside - 1)       # first belt pixel
    # stencil sources: belt rows [DR, nbr-DR) — margins go to scatter
    S0 = S_belt + DR * W
    n_rows = nbr - 2 * DR
    S1 = S0 + n_rows * W
    NR = out_pad.shape[0] - 0              # padded radial rows

    f32 = out_pad.dtype

    # ---- scatter part: caps + belt margins (static contiguous ids) ----
    # Targets of a cap/margin-source particle stay within its own
    # hemisphere's cap + one extra belt ring (landing ring ± neighbour
    # ring), so each hemisphere scatters into a COMPACT
    # [(2KR+1), NB]-window buffer — a small scatter target rather than
    # the full cube — then lands with one dynamic add.
    # Out-of-range targets (pathological displacements) POISON, matching
    # the belt-stencil contract.  out_pad rows = true row + KR.
    NRW = 2 * KR + 1
    NB_n = S0 + (DR + 1) * W            # north cap + margin + 1 ring
    NB_s = (npix - S1) + (DR + 1) * W   # south twin
    miss_sc = jnp.zeros((), jnp.int32)

    def scat_window(lo, hi, base, NB):
        """Compact scatter of source range [lo, hi) into a window whose
        pixel ids span [base, base + NB)."""
        w = (
            density[lo:hi, None, None]
            * rad_w[lo:hi, :, None]
            * pix_w[lo:hi, None, :]
        ).astype(f32)
        kr_l = rad_i[lo:hi].astype(jnp.int32) - ii + KR   # [n, 3]
        pix_l = pix_i[lo:hi].astype(jnp.int32) - base     # [n, 9]
        v = (
            ((kr_l >= 0) & (kr_l < NRW))[:, :, None]
            & ((pix_l >= 0) & (pix_l < NB))[:, None, :]
        )
        nmiss = jnp.sum((w > 0) & ~v).astype(jnp.int32)
        t = (
            jnp.clip(kr_l, 0, NRW - 1)[:, :, None] * NB
            + jnp.clip(pix_l, 0, NB - 1)[:, None, :]
        )
        loc = jnp.zeros((NRW * NB,), f32)
        loc = loc.at[t.reshape(-1)].add(jnp.where(v, w, 0.0).reshape(-1))
        return loc.reshape(NRW, NB), nmiss

    loc_n, m_n = scat_window(0, S0, 0, NB_n)
    loc_s, m_s = scat_window(S1, npix, npix - NB_s, NB_s)
    miss_sc = m_n + m_s
    cur = lax.dynamic_slice(out_pad, (ii, 0), (NRW, NB_n))
    out_pad = lax.dynamic_update_slice(out_pad, cur + loc_n, (ii, 0))
    cur = lax.dynamic_slice(out_pad, (ii, npix - NB_s), (NRW, NB_s))
    out_pad = lax.dynamic_update_slice(
        out_pad, cur + loc_s, (ii, npix - NB_s)
    )
    out_pad = out_pad + jnp.where(miss_sc > 0, jnp.nan, 0.0).astype(f32)

    # ---- stencil part ---------------------------------------------------
    dsl = lambda a: lax.slice_in_dim(a, S0, S1, axis=0)
    pi = dsl(pix_i)                                   # [n, 9]
    pw = dsl(pix_w).astype(f32)
    ri = dsl(rad_i)                                   # [n, 3]
    rw = dsl(rad_w).astype(f32)
    den = dsl(density).astype(f32)

    src_row = (jnp.arange(n_rows * W, dtype=jnp.int32) // W)[:, None]
    src_col = (jnp.arange(n_rows * W, dtype=jnp.int32) % W)[:, None]
    trow = (pi - S0).astype(jnp.int32) // W           # target row − 0
    tcol = (pi - S0).astype(jnp.int32) % W
    dr = trow - src_row                               # [n, 9]
    dj = tcol - src_col
    dj = ((dj + W // 2) % W) - W // 2                 # φ wrap
    kr = ri - ii                                      # [n, 3] radial offs

    live_p = pw > 0
    live_r = rw > 0
    # poison on any live update outside the stencil ranges (exactness)
    miss = (
        jnp.sum(live_p & ((jnp.abs(dr) > DR) | (jnp.abs(dj) > DJ)))
        + jnp.sum(live_r & (jnp.abs(kr) > KR))
    )
    poison = jnp.where(miss > 0, jnp.nan, 0.0).astype(f32)

    # radial slot weights per kr offset: [2KR+1, n]
    wr_k = jnp.stack(
        [jnp.sum(jnp.where(kr == c, rw, 0.0), axis=1)
         for c in range(-KR, KR + 1)]
    )
    # accumulator covers the FULL belt [nbr rows]: stencil sources live
    # in rows [DR, nbr-DR) and their |a| <= DR shifted targets land
    # anywhere in [0, nbr) — margin rows receive boundary mass here
    # Per ring offset a: sum the φ-rolls FIRST, then apply ONE slice-add.
    # The previous per-(a, b) accumulation interleaved (2DR+1)(2DJ+1)=99
    # dynamic-update-slice+add chains in the scan body, which sent XLA's
    # algebraic simplifier into its 50-run circular-rewrite guard on the
    # SPMD-partitioned scan region (MULTICHIP_r03; bisected to this loop
    # in round 4).  Row-summing keeps the adds dense and leaves only
    # (2DR+1) update chains; values are identical up to f32 addition
    # order within a ring row.
    acc = jnp.zeros((2 * KR + 1, nbr, W), f32)
    for a in range(-DR, DR + 1):
        rows = jnp.zeros((2 * KR + 1, n_rows, W), f32)
        for b in range(-DJ, DJ + 1):
            wk = jnp.sum(jnp.where((dr == a) & (dj == b), pw, 0.0), axis=1)
            m = (den * wk)[None, :] * wr_k            # [2KR+1, n]
            m = m.reshape(2 * KR + 1, n_rows, W)
            # shift source → target: out[r+a, j+b] += m[r, j]
            rows = rows + jnp.roll(m, b, axis=2)
        acc = acc.at[:, DR + a : DR + a + n_rows, :].add(rows)
    acc = acc + poison

    # add the acc planes into padded output rows [ii+c+KR], full belt
    # span — one contiguous (2KR+1)-row window, always in-bounds
    cur = lax.dynamic_slice(out_pad, (ii, S_belt), (2 * KR + 1, nbr * W))
    out_pad = lax.dynamic_update_slice(
        out_pad, cur + acc.reshape(2 * KR + 1, -1), (ii, S_belt)
    )
    return out_pad


def za_density_sph(
    psi,
    delta_bias,
    delta_m,
    chi,
    nside,
    sigma_chi=None,
    *,
    geometry=None,
    chunk=1,
    deposit="auto",
    offset_window=(4, 6, 3),
    stencil_window=(4, 5, 4),
    vectors="table",
):
    """Zel'dovich density via SPH mass assignment — fully on-device.

    Particles on each (chi, pixel) grid point are displaced by psi, then
    their (biased) mass is spread with Gaussian weights over the 9
    neighbouring pixels and ±1 radial bins (reference lss.py:1305-1419).

    Parameters
    ----------
    psi : [3, nchi, npix]
        Displacement field (radial, theta, phi/sin(theta)).
    delta_bias, delta_m : [nchi, npix]
        Biased mass field and matter field (sets particle sizes).
    chi : [nchi]
    nside : int
    sigma_chi : float, optional
        Radial smoothing at mean density (default: half mean bin width).
    geometry : dict, optional
        Precomputed host geometry tables (see `sph_geometry`).
    chunk : int
        Number of chi slices scattered per scan step.
    deposit : {"auto", "scatter", "window", "offset"}
        Mass-deposit algorithm.  "scatter" (the "auto" choice): the
        deterministic XLA scatter-add.  The two alternatives lost to it
        on the earlier accelerator and are kept, verified exact, until
        the GPU measurement (ROADMAP Speed 9): "window" (same scatter
        volume into a small per-slice radial buffer; its per-slice
        fallback bookkeeping ate the buffer-locality gain) and "offset"
        (scatter-free ring-locality gather deposit,
        :func:`_offset_deposit`; the DIA diagonals are ~8% dense, so it
        moves ~50× more elements).
    offset_window : (R, E, KR0)
        Offset-deposit window: ring offsets |ρ| ≤ R, intra-ring offsets
        |ε| ≤ E, radial offsets |kr| ≤ KR0.  Contributions outside the
        window are handled exactly by the fallback scatter — widen for
        very large displacement fields to keep the fast path dominant.
    stencil_window : (DR, DJ, KR)
        ``deposit="stencil"`` ranges: the belt deposit runs as
        (2DR+1)(2DJ+1)(2KR+1) masked roll-adds (see
        :func:`_stencil_deposit`); belt updates outside the ranges
        POISON the output with NaN (never silent mass loss).
    vectors : {"table", "arith"}
        Neighbour centre vectors from the precomputed table (gathered
        per particle) or computed arithmetically from the pixel ids
        (:func:`_pix2vec_jax`, ~4e-7 agreement — changes SPH weights at
        the same level).

    Returns
    -------
    out : [nchi, npix] density contrast.
    """
    from ..healpix import pixel as hpx

    nchi, npix = delta_bias.shape

    # Frequency-ordered inputs have a *descending* radial axis; the binning
    # assumes ascending chi, so flip in and out.
    chi_host = np.asarray(chi)
    if nchi > 1 and chi_host[1] < chi_host[0]:
        out = za_density_sph(
            psi[:, ::-1],
            delta_bias[::-1],
            delta_m[::-1],
            chi_host[::-1],
            nside,
            sigma_chi=sigma_chi,
            geometry=geometry,
            chunk=chunk,
            deposit=deposit,
            offset_window=offset_window,
            stencil_window=stencil_window,
            vectors=vectors,
        )
        return out[::-1]

    if deposit == "auto":
        deposit = "scatter"

    if geometry is None:
        geometry = sph_geometry(
            nside, rings=deposit == "offset", vectors=vectors != "arith"
        )
    elif deposit == "offset" and "r_of" not in geometry:
        geometry = dict(geometry, **_ring_tables(nside))

    angpos = geometry["angpos"]  # [2, npix]
    nn_ind = geometry["nn_ind"]  # [npix, 9]
    nn_vec = geometry.get("nn_vec")  # [npix, 9, 3] (None with vectors="arith")
    if nn_vec is None and vectors != "arith":
        raise ValueError(
            "geometry has no nn_vec table; build with vectors=True or "
            'call with vectors="arith"'
        )

    if sigma_chi is None:
        sigma_chi = float(np.mean(np.abs(np.diff(np.asarray(chi)))) / 2)
    sigma_ang = hpx.nside2resol(nside) / 2

    chi = jnp.asarray(chi)

    R, E, KR0 = offset_window
    r0 = 2 + 2 * R  # ring-length ratio over |ρ| ≤ R stays < 1.55 (2-cand.)
    # fallback capacity: ~1/8 of the particles per slice may spill out of
    # the radial window before the deposit poisons (see _window_deposit)
    cap = 9 * (npix // 8) + 27 * 4 * r0 * (r0 + 1)

    def slice_update(out, ii):
        density = 1.0 + jax.lax.dynamic_index_in_dim(delta_bias, ii, 0, False)
        dm = jax.lax.dynamic_index_in_dim(delta_m, ii, 0, False)
        psi_r = jax.lax.dynamic_index_in_dim(psi[0], ii, 0, False)
        psi_t = jax.lax.dynamic_index_in_dim(psi[1], ii, 0, False)
        psi_p = jax.lax.dynamic_index_in_dim(psi[2], ii, 0, False)

        scaling = jnp.clip(1.0 + dm, 0.1, 3.0) ** (-1.0 / 3)

        new_ang = calculate_positions(angpos, jnp.stack([psi_t, psi_p]))
        new_chi = chi[ii] + psi_r

        new_ang_ind = _ang2pix_jax(nside, new_ang[0], new_ang[1])
        st = jnp.sin(new_ang[0])
        new_ang_vec = jnp.stack(
            [st * jnp.cos(new_ang[1]), st * jnp.sin(new_ang[1]), jnp.cos(new_ang[0])],
            axis=-1,
        )

        pix_i, pix_w = pixel_weights(
            new_ang_ind, new_ang_vec, scaling, sigma_ang, nn_ind,
            None if vectors == "arith" else nn_vec, nside=nside,
        )
        chi_ind = jnp.searchsorted(chi, new_chi)
        rad_i, rad_w = radial_weights(
            chi_ind, new_chi, scaling, sigma_chi, 1, chi
        )
        if deposit == "offset":
            return _offset_deposit(
                geometry, nside, ii, density, pix_i, pix_w, rad_i, rad_w,
                out, R, E, KR0, r0, cap,
            )
        if deposit == "window":
            return _window_deposit(
                ii, density, pix_i, pix_w, rad_i, rad_w, out, KR0, cap
            )
        if deposit == "stencil":
            DR, DJ, KRs = stencil_window
            return _stencil_deposit(
                ii, density, pix_i, pix_w, rad_i, rad_w, out,
                nside, DR, DJ, KRs,
            )
        return bin_delta(density, pix_i, pix_w, rad_i, rad_w, out)

    def step(out, ii):
        return slice_update(out, ii), None

    if deposit in ("offset", "window", "stencil"):
        # radial rows padded on both ends: the per-slice deposit
        # window [ii−KR, ii+KR] then always lands in-bounds
        KRp = stencil_window[2] if deposit == "stencil" else KR0
        out0 = jnp.zeros((nchi + 2 * KRp, npix), dtype=delta_bias.dtype)
        out, _ = jax.lax.scan(step, out0, jnp.arange(nchi))
        return out[KRp : KRp + nchi] - 1.0

    out0 = jnp.zeros((nchi, npix), dtype=delta_bias.dtype)
    out, _ = jax.lax.scan(step, out0, jnp.arange(nchi))
    return out - 1.0


def sph_geometry(nside, rings=False, device=True, vectors=True):
    """Host-precomputed geometry tables for the SPH gridder.

    With ``rings=True`` the dict also carries the per-ring tables the
    offset deposit needs (see :func:`_ring_tables`).

    ``device=False`` returns plain numpy arrays.  Use this to ship the
    tables through jit ARGUMENTS (after an explicit transfer) rather
    than closing over device arrays: closure-captured tables become
    lowering-time constants in the compiled program, which at nside=512
    is ~0.5 GB of angpos+nn_ind+nn_vec.

    ``vectors=False`` skips the ``nn_vec`` neighbour-vector table (the
    largest: npix·9·3 floats) for ``vectors="arith"`` deposit callers
    that compute the vectors on the fly with :func:`_pix2vec_jax`.
    """
    from ..healpix import pixel as hpx

    cvt = jnp.asarray if device else np.asarray
    npix = hpx.nside2npix(nside)
    th, ph = hpx.pix2ang(nside, np.arange(npix))
    angpos = np.stack([th, ph])

    nn_ind = np.zeros((npix, 9), dtype=np.int64)
    nn_ind[:, 0] = np.arange(npix)
    nn_ind[:, 1:] = hpx.get_all_neighbours(nside, np.arange(npix)).T

    g = dict(angpos=cvt(angpos), nn_ind=cvt(nn_ind))
    if vectors:
        safe = np.where(nn_ind >= 0, nn_ind, 0)
        x, y, z = hpx.pix2vec(nside, safe.ravel())
        nn_vec = np.stack([x, y, z], axis=-1).reshape(npix, 9, 3)
        g["nn_vec"] = cvt(nn_vec)
    if rings:
        g.update({k: cvt(v) for k, v in _ring_tables_np(nside).items()})
    return g


def _ring_tables_np(nside):
    """Per-ring / per-pixel index tables for the offset deposit (numpy)."""
    from ..healpix import pixel as hpx

    info = hpx.ring_info(nside)
    nphi = info["nphi"]
    start = info["start"]
    nring = nphi.size
    npix = hpx.nside2npix(nside)
    r_of = np.repeat(np.arange(nring, dtype=np.int32), nphi)
    j_of = (np.arange(npix) - start[r_of]).astype(np.int32)
    # A_r = phi0·n/(2π): the first pixel's offset in its own grid units
    A_r = (info["phi0"] * nphi / (2.0 * np.pi)).astype(np.float32)
    return dict(
        r_of=r_of,
        j_of=j_of,
        nq_f=nphi.astype(np.float32),
        A_r=np.round(A_r * 2.0) / 2.0,  # exact {0, 0.5}
        start_r=start.astype(np.int32),
    )


def _ring_tables(nside):
    """Per-ring / per-pixel index tables for the offset deposit (device)."""
    return {k: jnp.asarray(v) for k, v in _ring_tables_np(nside).items()}


def _pix2vec_jax(nside, ipix):
    """RING pix2vec, jittable (mirror of healpix.pixel.pix2ang + ang2vec).

    Replaces the [npart, 9, 3] ``nn_vec`` table gather in the SPH
    pipeline (the gather moves 21 M elements per chi slice at nside=256)
    with pure VPU arithmetic on the neighbour pixel ids.  The cap ring
    index comes from a float isqrt with an exact INTEGER fix-up against
    the ring-start formula 2·i·(i−1), so the ring classification is
    exact even where f32 sqrt rounding straddles a boundary.
    """
    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)
    idt = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    p = ipix.astype(idt)

    def cap_ring(pc):
        """Ring index i >= 1 of cap pixel pc (north convention)."""
        i = jnp.sqrt(0.5 * (pc.astype(fdt) + 1.0)).astype(idt) + 1
        # integer fix-up: ring i starts at 2 i (i−1) — exact in ints
        for _ in range(2):
            i = jnp.where(2 * i * (i - 1) > pc, i - 1, i)
            i = jnp.where(2 * (i + 1) * i <= pc, i + 1, i)
        return jnp.maximum(i, 1)

    # north cap.  1−z = i²/3n² exactly, so sinθ comes cancellation-free
    # from st² = (1−z)(1+z) — the naive sqrt(1−z²) loses ~half the f32
    # bits on the polar rings.
    i_n = cap_ring(p)
    j_n = p + 1 - 2 * i_n * (i_n - 1)
    omz_n = i_n.astype(fdt) ** 2 / (3.0 * nside**2)
    z_n = 1.0 - omz_n
    st_n = jnp.sqrt(omz_n * (2.0 - omz_n))
    phi_n = (j_n.astype(fdt) - 0.5) / i_n.astype(fdt) * (jnp.pi / 2)

    # equatorial belt (|z| <= 2/3: no cancellation in 1 − z²)
    pe = p - ncap
    i_e = pe // (4 * nside) + nside
    j_e = pe % (4 * nside) + 1
    s_e = (i_e - nside + 1) % 2
    z_e = 4.0 / 3.0 - 2.0 * i_e.astype(fdt) / (3.0 * nside)
    st_e = jnp.sqrt(jnp.maximum(1.0 - z_e * z_e, 0.0))
    phi_e = (j_e.astype(fdt) - 1.0 + 0.5 * s_e.astype(fdt)) / nside * (
        jnp.pi / 2
    )

    # south cap
    ps = npix - 1 - p
    i_s = cap_ring(ps)
    j_s = ps + 1 - 2 * i_s * (i_s - 1)
    j_s = 4 * i_s + 1 - j_s
    omz_s = i_s.astype(fdt) ** 2 / (3.0 * nside**2)
    z_s = -(1.0 - omz_s)
    st_s = jnp.sqrt(omz_s * (2.0 - omz_s))
    phi_s = (j_s.astype(fdt) - 0.5) / i_s.astype(fdt) * (jnp.pi / 2)

    in_n = p < ncap
    in_s = p >= npix - ncap
    z = jnp.where(in_n, z_n, jnp.where(in_s, z_s, z_e))
    st = jnp.where(in_n, st_n, jnp.where(in_s, st_s, st_e))
    phi = jnp.where(in_n, phi_n, jnp.where(in_s, phi_s, phi_e))
    return jnp.stack(
        [st * jnp.cos(phi), st * jnp.sin(phi), z], axis=-1
    )


def _ang2pix_jax(nside, theta, phi):
    """RING ang2pix, jittable (mirror of healpix.pixel.ang2pix)."""
    z = jnp.cos(theta)
    za = jnp.abs(z)
    tt = jnp.mod(phi, 2 * jnp.pi) / (0.5 * jnp.pi)

    npix = 12 * nside * nside
    ncap = 2 * nside * (nside - 1)

    # index dtype: int32 holds every intermediate up to nside=8192
    # (npix < 2^31); avoids the silent int64->int32 truncation warning in
    # non-x64 accelerator processes
    idt = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32

    # equatorial
    temp1 = nside * (0.5 + tt)
    temp2 = nside * 0.75 * z
    jp_e = jnp.floor(temp1 - temp2).astype(idt)
    jm_e = jnp.floor(temp1 + temp2).astype(idt)
    ir_e = nside + 1 + jp_e - jm_e
    kshift = 1 - (ir_e & 1)
    ip_e = jnp.mod((jp_e + jm_e - nside + kshift + 1) // 2, 4 * nside)
    pix_eq = ncap + (ir_e - 1) * 4 * nside + ip_e

    # polar caps
    tp = tt - jnp.floor(tt)
    tmp = nside * jnp.sqrt(jnp.maximum(3.0 * (1.0 - za), 0.0))
    jp_c = (tp * tmp).astype(idt)
    jm_c = ((1.0 - tp) * tmp).astype(idt)
    ir_c = jp_c + jm_c + 1
    ip_c = jnp.mod((tt * ir_c).astype(idt), 4 * ir_c)
    pix_n = 2 * ir_c * (ir_c - 1) + ip_c
    pix_s = npix - 2 * ir_c * (ir_c + 1) + ip_c
    pix_cap = jnp.where(z > 0, pix_n, pix_s)

    return jnp.where(za <= 2.0 / 3.0, pix_eq, pix_cap)
