"""Sharded LSS pipeline programs — the reference's MPI-parallel L5 layer.

The reference runs its LSS chain MPI-distributed end to end: the initial
(φ, δ) draw is ℓ-sharded then redistributed pixel→chi
(``cora/signal/lss.py:441-474``), gradients/dynamics re-shard to pixel
(``lss.py:806-811``, ``:886``), FoG matmuls run pixel-distributed
(``lss.py:1202``) and shot noise fills chi-shards (``lss.py:1287``).

Here each of those becomes ONE pjit/shard_map device program over a 1-D
mesh whose axis carries the radial (chi) dimension:

* :func:`initial_lss_sharded` — ℓ-sharded covariance root + correlated
  draw, an ℓ→chi sharding-constraint transpose (XLA emits the all-to-all
  the reference does over MPI), chi-sharded batched SHT.
* :func:`gradient_sharded` — chi-sharded analysis + spin-1 synthesis for
  the angular gradient; the radial derivative is a pixel-sharded matmul
  with the :func:`~cora_tpu.signal.lssutil.gradient_matrix` stencil (the
  reference's pixel-redistributed ``np.gradient`` loop).
* :func:`linear_dynamics_sharded` / :func:`fog_sharded` — radial
  operators as pixel-sharded matmuls (diff2 stencil / FoG kernel).
* :func:`shot_noise_sharded` — keyed chi-sharded noise fill.
* :func:`za_density_sph_sharded` — the Zel'dovich SPH deposit under
  shard_map: each device scatters its own chi slices into a halo-padded
  local buffer; one ppermute pair reconciles mass deposited across shard
  boundaries (the only communication in the deposit).
* :func:`zeldovich_sharded` — the whole ZA step (gradient → growth/RSD
  scaling → SPH deposit) with device-resident intermediates.

Every program is checked for equality against its single-device
counterpart on the 8-device virtual mesh (tests/test_parallel_lss.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P



def _sharding(mesh, *spec):
    return NamedSharding(mesh, P(*spec))


def _wsc(x, mesh, *spec):
    return jax.lax.with_sharding_constraint(x, _sharding(mesh, *spec))


def initial_lss_sharded(cla, nside, key, mesh, mesh_axis="freq",
                        dtype=None):
    """Correlated (φ, δ) realisation from the joint C_l, chi-sharded.

    Phase 1 factorises the per-ℓ joint covariance and draws a_lm sharded
    over ℓ; the phase boundary is a single sharding constraint (the
    reference's MPI redistribute, lss.py:450 + 468-474); phase 2 runs the
    batched SHT with the 2·nz field rows sharded over the mesh.

    Parameters
    ----------
    cla : [lmax+1, 2 nz, 2 nz] joint (φ, δ) covariance per ℓ.
    nside : int
    key : jax.random.PRNGKey
    mesh : 1-D mesh; 2·nz should be divisible by its size.

    Returns
    -------
    sky : jnp [2 nz, 12 nside²], rows (φ then δ) sharded over the mesh.
    """
    from ..core.skysim import draw_correlated_alm
    from ..healpix.sht import get_sht, _synthesis

    cla = jnp.asarray(cla)
    lmax = cla.shape[0] - 1
    if dtype is None:
        dtype = (
            jnp.complex128
            if jax.config.jax_enable_x64 and jax.default_backend() == "cpu"
            else jnp.complex64
        )
    op = get_sht(int(nside), int(lmax))
    t = op.tables(dtype == jnp.complex128)

    @jax.jit
    def _run(corr, key, t):
        corr = _wsc(corr, mesh, mesh_axis, None, None)  # ell-sharded
        alm = draw_correlated_alm(corr, key, dtype=dtype)  # [2nz, L, M]
        alm = _wsc(alm, mesh, mesh_axis, None, None)  # ell→chi all-to-all
        sky = _synthesis(op, t, alm)
        return _wsc(sky, mesh, mesh_axis, None)

    with mesh:
        return _run(cla, key, t)


def gradient_sharded(maps, x, mesh, grad0=True, lmax=None,
                     mesh_axis="freq"):
    """Sharded gradient of HEALPix shells: [d/dr, dθ/r, dφ/(r sinθ)].

    Mirrors :func:`cora_tpu.signal.lssutil.gradient`: chi-sharded
    analysis (Jacobi iter=3) + spin-1 synthesis for the angular part, a
    pixel-sharded ``gradient_matrix`` matmul for the radial part — the
    reference's two MPI transposes around healpy.alm2map_der1
    (lss.py:806-811) become two sharding constraints.

    Returns the [3, nchi, npix] gradient sharded over the chi axis.
    """
    from ..healpix import pixel as hpx
    from ..healpix import spin as _spin
    from ..healpix.sht import get_sht, _analysis
    from ..signal.lssutil import gradient_matrix

    maps = jnp.asarray(maps)
    x = np.asarray(x, dtype=np.float64)
    nside = hpx.npix2nside(maps.shape[1])
    if lmax is None:
        lmax = 2 * nside

    dbl = maps.dtype == jnp.float64
    op = get_sht(int(nside), int(lmax))
    sop = _spin.get_spin_sht(int(nside), int(lmax), 1)
    t = op.tables(dbl)
    ts = sop.tables(dbl)
    la = np.arange(lmax + 1, dtype=np.float64)
    fac = np.sqrt(la * (la + 1.0)).astype(
        np.float64 if dbl else np.float32
    )
    Gm = jnp.asarray(gradient_matrix(x) if grad0 else np.zeros((1, 1)),
                     dtype=maps.dtype)
    xd = jnp.asarray(x, dtype=maps.dtype)

    @jax.jit
    def _run(maps, Gm, xd, t, ts):
        maps = _wsc(maps, mesh, mesh_axis, None)
        alm = _analysis(op, t, maps, 3)
        almE = alm * jnp.asarray(fac)[:, None]
        dth, dph = sop._synthesis_impl(ts, -almE, jnp.zeros_like(almE))
        dth = _wsc(dth / xd[:, None], mesh, mesh_axis, None)
        dph = _wsc(dph / xd[:, None], mesh, mesh_axis, None)
        if grad0:
            mp = _wsc(maps, mesh, None, mesh_axis)  # chi→pixel transpose
            dr = _wsc(jnp.matmul(Gm, mp, precision=jax.lax.Precision.HIGHEST), mesh, None,
                      mesh_axis)
            dr = _wsc(dr, mesh, mesh_axis, None)  # pixel→chi transpose
        else:
            dr = jnp.zeros_like(dth)
        return _wsc(jnp.stack([dr, dth, dph]), mesh, None, mesh_axis, None)

    with mesh:
        return _run(maps, Gm, xd, t, ts)


def linear_dynamics_sharded(phi, delta, delta_bias, chi, D, frD, mesh,
                            mesh_axis="freq"):
    """First-order Eulerian dynamics + linear RSD, sharded over chi.

    ``out = delta_bias + D·delta − frD·∂²φ/∂χ²`` with the radial second
    derivative as a pixel-sharded diff2-stencil matmul (the reference
    re-shards to pixel for this operator, lss.py:886).

    Parameters
    ----------
    phi, delta, delta_bias : [nchi, npix]
    chi : [nchi]
    D : [nchi] growth factors (normalised to z=0).
    frD : [nchi] D·f product for the RSD term, or None to skip RSD.
    """
    from ..signal.lssutil import diff2_matrix

    phi = jnp.asarray(phi)
    D2 = jnp.asarray(diff2_matrix(np.asarray(chi)), dtype=phi.dtype)
    Dv = jnp.asarray(D, dtype=phi.dtype)
    fv = None if frD is None else jnp.asarray(frD, dtype=phi.dtype)

    @jax.jit
    def _run(phi, delta, delta_bias, D2, Dv, fv):
        out = _wsc(delta_bias, mesh, mesh_axis, None)
        out = out + Dv[:, None] * _wsc(delta, mesh, mesh_axis, None)
        if fv is not None:
            pp = _wsc(phi, mesh, None, mesh_axis)  # pixel-sharded
            vterm = _wsc(jnp.matmul(D2, pp, precision=jax.lax.Precision.HIGHEST), mesh, None,
                         mesh_axis)
            vterm = _wsc(vterm, mesh, mesh_axis, None)
            out = out - fv[:, None] * vterm
        return _wsc(out, mesh, mesh_axis, None)

    with mesh:
        return _run(phi, jnp.asarray(delta), jnp.asarray(delta_bias),
                    D2, Dv, fv)


def fog_sharded(K, field, mesh, mesh_axis="freq"):
    """Fingers-of-God radial smoothing: pixel-sharded K @ field matmul.

    The reference runs this matmul pixel-distributed (lss.py:1202); here
    the chi→pixel→chi transposes are two sharding constraints around one
    matmul.
    """
    field = jnp.asarray(field)
    K = jnp.asarray(K, dtype=field.dtype)

    @jax.jit
    def _run(K, field):
        fp = _wsc(field, mesh, None, mesh_axis)
        out = _wsc(jnp.matmul(K, fp, precision=jax.lax.Precision.HIGHEST), mesh, None, mesh_axis)
        return _wsc(out, mesh, mesh_axis, None)

    with mesh:
        return _run(K, field)


def shot_noise_sharded(key, std, shape, mesh, mesh_axis="freq",
                       dtype=jnp.float64):
    """Chi-sharded correlated shot-noise realisation.

    Keyed-RNG equivalent of the reference's chi-shard local fill
    (lss.py:1287): ``std[chi] · N(0, 1)``; jax.random bits are a pure
    function of (key, position), so the result is identical on any mesh.
    """
    std = jnp.asarray(std)

    @jax.jit
    def _run(key, std):
        noise = jax.random.normal(key, shape, dtype=dtype)
        return _wsc(std[:, None] * noise, mesh, mesh_axis, None)

    with mesh:
        return _run(key, std)


def za_density_sph_sharded(
    psi, delta_bias, delta_m, chi, nside, mesh, sigma_chi=None,
    mesh_axis="freq", halo=4, deposit="stencil", geometry=None,
    vectors="table", stencil_window=(4, 5),
):
    """Zel'dovich SPH mass assignment sharded over the chi axis.

    Each device runs the single-device deposit machinery
    (:mod:`cora_tpu.ops.pmesh`) over its own chi slices, scattering into
    a halo-padded local buffer ``[nloc + 2·halo, npix]``; a ppermute pair
    then adds the halo slabs into the neighbouring shards — mass a
    particle deposits across a shard boundary travels over ICI exactly
    once.  This replaces the reference's Cython/OpenMP scatter loop over
    MPI-local slices (lss.py:1305-1419 + pmesh_util.c:37-38).

    Particles displaced radially beyond the halo cannot deposit exactly;
    like the single-device window deposit, the output is POISONED with
    NaN rather than silently dropping mass — raise ``halo`` for fields
    with large radial displacements (ZA displacements are a few bins at
    production bin widths).

    chi must be ascending (callers flip frequency-ordered fields on
    host, as :func:`cora_tpu.ops.pmesh.za_density_sph` does).

    ``geometry``: precomputed pixel tables (see
    :func:`cora_tpu.ops.pmesh.sph_geometry`; host arrays accepted).  The
    tables travel through the program's jit ARGUMENTS, never as closure
    constants — at nside>=512 closure-captured tables (~0.5 GB) would
    land in the compiled program.

    ``vectors="arith"`` computes neighbour centre vectors arithmetically
    from the pixel ids (:func:`cora_tpu.ops.pmesh._pix2vec_jax`) instead
    of gathering the ``nn_vec`` table — drops the largest table
    (npix·9·3 floats; ~340 MB at nside=512) from both transfer and
    device memory.

    ``stencil_window``: (DR, DJ) belt roll-add ranges for
    ``deposit="stencil"``; the radial range is the halo.

    Returns the [nchi, npix] density contrast, chi-sharded.
    """
    from ..healpix import pixel as hpx
    from ..ops import pmesh as pm
    from ..util import xfer

    nchi, npix = delta_bias.shape
    n_dev = mesh.shape[mesh_axis]
    if nchi % n_dev:
        raise ValueError(f"nchi={nchi} not divisible by mesh size {n_dev}")
    nloc = nchi // n_dev
    # halo must not exceed the local slab: the single ppermute hop only
    # reconciles with immediate neighbours, so pad rows reaching shard
    # d±2 would be dropped silently.  Clamping keeps the exactness
    # contract — particles beyond the (reduced) halo poison via nmiss.
    H = int(min(halo, nloc))
    chi_host = np.asarray(chi)
    if nchi > 1 and chi_host[1] < chi_host[0]:
        raise ValueError("za_density_sph_sharded requires ascending chi")

    use_vec_table = vectors != "arith"
    if geometry is None:
        geometry = pm.sph_geometry(nside, device=False, vectors=use_vec_table)
    tables = [xfer.put(geometry["angpos"]), xfer.put(geometry["nn_ind"])]
    if use_vec_table:
        tables.append(xfer.put(geometry["nn_vec"]))
    if sigma_chi is None:
        sigma_chi = float(np.mean(np.abs(np.diff(chi_host))) / 2)
    sigma_ang = hpx.nside2resol(nside) / 2
    DR, DJ = stencil_window

    spec_psi = P(None, mesh_axis, None)
    spec_f = P(mesh_axis, None)

    def _rep(a):
        return P(*(None,) * np.ndim(a))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            (spec_psi, spec_f, spec_f, P(None))
            + tuple(_rep(t) for t in tables)
        ),
        out_specs=spec_f,
        check_vma=False,
    )
    def _local(psi_l, db_l, dm_l, chi_g, angpos, nn_ind, *nn_vec_opt):
        nn_vec = nn_vec_opt[0] if nn_vec_opt else None
        lo = jax.lax.axis_index(mesh_axis) * nloc
        out0 = jnp.zeros((nloc + 2 * H, npix), dtype=db_l.dtype)
        nmiss0 = jnp.zeros((), jnp.int32)

        def step(carry, ii_loc):
            out, nmiss = carry
            density = 1.0 + db_l[ii_loc]
            dm = dm_l[ii_loc]
            scaling = jnp.clip(1.0 + dm, 0.1, 3.0) ** (-1.0 / 3)

            new_ang = pm.calculate_positions(
                angpos, jnp.stack([psi_l[1, ii_loc], psi_l[2, ii_loc]])
            )
            new_chi = chi_g[lo + ii_loc] + psi_l[0, ii_loc]

            new_ang_ind = pm._ang2pix_jax(nside, new_ang[0], new_ang[1])
            st = jnp.sin(new_ang[0])
            new_ang_vec = jnp.stack(
                [st * jnp.cos(new_ang[1]), st * jnp.sin(new_ang[1]),
                 jnp.cos(new_ang[0])],
                axis=-1,
            )
            pix_i, pix_w = pm.pixel_weights(
                new_ang_ind, new_ang_vec, scaling, sigma_ang, nn_ind,
                nn_vec, nside=nside,
            )
            chi_ind = jnp.searchsorted(chi_g, new_chi)
            rad_i, rad_w = pm.radial_weights(
                chi_ind, new_chi, scaling, sigma_chi, 1, chi_g
            )
            if deposit == "stencil":
                # the single-device stencil deposit drops in: its padded
                # rows (true + KR) ARE the halo-padded local rows
                # (rad_i − lo + H) with ii → ii_loc, KR → H; radial
                # outliers beyond ±H poison inside (same halo contract)
                out = pm._stencil_deposit(
                    ii_loc, density, pix_i, pix_w, rad_i - lo, rad_w,
                    out, nside, DR, DJ, H,
                )
                return (out, nmiss), None
            # global radial bin → local halo-padded row
            t_loc = rad_i - lo + H
            valid = (t_loc >= 0) & (t_loc < nloc + 2 * H)
            nmiss = nmiss + jnp.sum(~valid).astype(jnp.int32)
            w = (
                density[:, None, None]
                * jnp.where(valid, rad_w, 0.0)[:, :, None]
                * pix_w[:, None, :]
            )
            tgt = (
                jnp.clip(t_loc, 0, nloc + 2 * H - 1)[:, :, None] * npix
                + pix_i[:, None, :]
            )
            out = out.reshape(-1).at[tgt.reshape(-1)].add(
                w.reshape(-1)
            ).reshape(nloc + 2 * H, npix)
            return (out, nmiss), None

        (out, nmiss), _ = jax.lax.scan(
            step, (out0, nmiss0), jnp.arange(nloc)
        )

        # halo reconciliation: my left pad rows [0, H) are global bins
        # lo−H..lo−1 (left neighbour's tail), my right pad rows are the
        # right neighbour's head.  Send each pad to its owner and add.
        perm_l = [(d, d - 1) for d in range(1, n_dev)]
        perm_r = [(d, d + 1) for d in range(n_dev - 1)]
        from_right = jax.lax.ppermute(out[:H], mesh_axis, perm_l)
        from_left = jax.lax.ppermute(out[nloc + H:], mesh_axis, perm_r)
        out = out.at[nloc:nloc + H].add(from_right)
        out = out.at[H:2 * H].add(from_left)

        res = out[H:H + nloc] - 1.0
        # radial-outlier overflow poisons (exactness contract, as in
        # ops.pmesh._window_deposit): never silently drop mass
        total_miss = jax.lax.psum(nmiss, mesh_axis)
        return res + jnp.where(total_miss > 0, jnp.nan, 0.0)

    with mesh:
        return jax.jit(_local)(
            jnp.asarray(psi), jnp.asarray(delta_bias),
            jnp.asarray(delta_m), jnp.asarray(chi), *tables,
        )


def zeldovich_sharded(
    phi, delta, delta_bias, chi, D, fr, nside, mesh,
    redshift_space=True, mesh_axis="freq", halo=4,
    deposit="stencil", vectors="table", geometry=None,
):
    """Full sharded Zel'dovich step: ∇φ → growth/RSD scaling → deposit.

    Device-resident composition of :func:`gradient_sharded` and
    :func:`za_density_sph_sharded` — the task-level equivalent of
    ZeldovichDynamics.process on a mesh (reference lss.py:777-858).

    Parameters
    ----------
    phi, delta, delta_bias : [nchi, npix] host or device arrays.
    chi : [nchi] (any ordering; flipped internally to ascending).
    D : [nchi] growth factors D(z)/D(0).
    fr : [nchi] growth rates f(z) (used when redshift_space).
    deposit, vectors, geometry :
        Passed to :func:`za_density_sph_sharded` (geometry tables are
        shipped through jit arguments — required at nside>=512).
    """
    from ..healpix import transforms as hputil

    chi_host = np.asarray(chi, dtype=np.float64)
    D = np.asarray(D, dtype=np.float64)

    vpsi = gradient_sharded(phi, chi_host, mesh, mesh_axis=mesh_axis)

    theta = hputil.ang_positions(int(nside))[:, 0]

    with mesh:
        sin_t = jnp.asarray(np.sin(theta), dtype=vpsi.dtype)
        Dv = jnp.asarray(D, dtype=vpsi.dtype)
        frv = jnp.asarray(np.asarray(fr), dtype=vpsi.dtype)
        chi_d = jnp.asarray(chi_host, dtype=vpsi.dtype)

        @jax.jit
        def _scale(vpsi, Dv, frv, chi_d, sin_t, delta):
            # psi = D·∇φ with 1/chi (and 1/sinθ) metric factors on the
            # angular components and the (1+f) RSD boost on the radial
            # one — factor order matches ZeldovichDynamics.process
            # exactly (the deposit's bin assignments are discontinuous
            # in the positions, so fp-identical scaling matters)
            v = vpsi * Dv[None, :, None]
            v = v.at[1].divide(chi_d[:, None])
            v = v.at[2].divide(chi_d[:, None])
            v = v.at[2].divide(sin_t[None, :])
            if redshift_space:
                v = v.at[0].multiply((1.0 + frv)[:, None])
            dm = delta * Dv[:, None].astype(delta.dtype)
            return (
                _wsc(v, mesh, None, mesh_axis, None),
                _wsc(dm, mesh, mesh_axis, None),
            )

        vpsi_s, delta_m = _scale(
            vpsi, Dv, frv, chi_d, sin_t, jnp.asarray(delta)
        )

    kw = dict(
        mesh_axis=mesh_axis, halo=halo, deposit=deposit,
        vectors=vectors, geometry=geometry,
    )
    # ascending-chi requirement: flip on host if frequency-ordered
    if len(chi_host) > 1 and chi_host[1] < chi_host[0]:
        out = za_density_sph_sharded(
            np.asarray(vpsi_s)[:, ::-1],
            np.asarray(delta_bias)[::-1],
            np.asarray(delta_m)[::-1],
            chi_host[::-1],
            nside, mesh, **kw,
        )
        return np.asarray(out)[::-1]
    return za_density_sph_sharded(
        vpsi_s, delta_bias, delta_m, chi_host, nside, mesh, **kw,
    )
