"""Mesh construction and the sharded synthesis program.

The reference's parallel pattern (SURVEY.md "parallelism strategies") is
phase-wise axis sharding with global transposes:

* factorise C_l and draw a_lm sharded over ell (skysim.py:108-121),
* all-to-all to frequency shards (skysim.py:128),
* batched inverse SHT over local frequencies (skysim.py:130).

Here the whole thing is ONE pjit program over a 1-D mesh: the ell-sharded
eigh/draw and the freq-sharded SHT are connected by a
``with_sharding_constraint`` — XLA emits the ell→freq all-to-all over the interconnect.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis_name="freq", devices=None):
    """Create a 1-D device mesh over the synthesis axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_over(x, mesh, axis=0, mesh_axis="freq"):
    """Place an array with one dimension sharded over the mesh axis."""
    spec = [None] * x.ndim
    spec[axis] = mesh_axis
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def redistribute(x, mesh, axis, mesh_axis="freq"):
    """Change the sharded dimension of an array (MPIArray.redistribute
    equivalent).  Inside jit this lowers to an all-to-all over the interconnect."""
    spec = [None] * x.ndim
    spec[axis] = mesh_axis
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P(*spec)))


def mkfullsky_sharded(corr, nside, lmax, key, mesh, dtype=jnp.complex64):
    """Full correlated-sky synthesis sharded over a device mesh.

    Phase 1 (ell-sharded): per-ell covariance root + correlated draw.
    Phase 2 (freq-sharded): batched native SHT.  The phase boundary is a
    single sharding constraint (the reference's MPI all-to-all,
    skysim.py:128).

    Parameters
    ----------
    corr : array [lmax+1, nz, nz]
    nside, lmax : int
    key : jax.random.PRNGKey
    mesh : jax.sharding.Mesh with axis "freq"

    Returns
    -------
    maps : jnp.ndarray[nz, 12*nside**2], sharded over nz.
    """
    from ..core.skysim import draw_correlated_alm
    from ..healpix.sht import get_sht, _synthesis_grid

    op = get_sht(int(nside), int(lmax))
    tables = op.tables(False)

    ell_sharding = NamedSharding(mesh, P("freq", None, None))
    freq_sharding = NamedSharding(mesh, P("freq", None, None))
    out_sharding = NamedSharding(mesh, P("freq", None, None))

    # the SHT tables are jit arguments, not closure constants: at nside
    # 256 the Λ chunks are ~0.4 GB, and as constants they are compiled
    # into the executable (minutes of compile per mesh)
    @jax.jit
    def _run(corr, key, tables):
        # Phase 1: ell-sharded factorisation + draw
        corr = jax.lax.with_sharding_constraint(corr, ell_sharding)
        alm = draw_correlated_alm(corr, key, dtype=dtype)  # [nz, L, M]
        # Phase boundary: redistribute ell->freq (all-to-all over the interconnect)
        alm = jax.lax.with_sharding_constraint(alm, freq_sharding)
        # Phase 2: freq-sharded batched SHT (dense ring-grid layout)
        sky = _synthesis_grid(op, tables, alm)
        return jax.lax.with_sharding_constraint(sky, out_sharding)

    with mesh:
        return _run(jnp.asarray(corr), key, tables)


def synthesize_cube_sharded(
    op, tables, roots, key, mesh, fchunk=None, mesh_axis="freq"
):
    """Streamed correlated synthesis sharded over frequency.

    Multi-chip form of :func:`cora_tpu.healpix.sht.synthesis_grid_correlated`
    built with ``shard_map``: every device regenerates the identical per-ℓ
    white-noise blocks from the same key (RNG is cheap and deterministic)
    and contracts only its own rows of the covariance roots — so the
    frequency axis scales with zero inter-chip communication (the
    reference needs an MPI all-to-all here, skysim.py:128; streaming the
    draw removes it entirely).

    Parameters
    ----------
    op, tables : SHT operator (cached legendre mode) and its device tables.
    roots : [L, nz, nz] real per-ell covariance roots; nz must be divisible
        by mesh size.
    fchunk : frequencies synthesized per inner step on each device.

    Returns
    -------
    [nz, nring, nq_max] dense ring-grid cube, sharded over frequency.
    """
    from functools import partial

    shard_map = jax.shard_map
    from ..healpix.sht import synthesis_scan_correlated

    n_dev = mesh.shape[mesh_axis]
    L, _, nz = roots.shape
    if nz % n_dev:
        raise ValueError(f"nz={nz} not divisible by mesh size {n_dev}")
    nloc = nz // n_dev
    fchunk = min(fchunk or nloc, nloc)

    spec_r = P(None, mesh_axis, None)  # roots sharded over the z-row axis
    spec_o = P(mesh_axis, None, None)
    # replicated tables, shipped as arguments (as closure constants they
    # would be compiled into the executable); a spec per leaf
    t_specs = jax.tree.map(lambda v: P(*([None] * jnp.ndim(v))), tables)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(t_specs, spec_r, P()),
        out_specs=spec_o,
        check_vma=False,
    )
    def _local(t_loc, roots_rows, key):
        # roots_rows: [L, nloc, nz] — this device's output frequencies.
        # Two-level scan: Legendre stage over all local frequencies (full
        # matmul rows, one-shot RNG), ring stage at fchunk.
        nring = 4 * op.nside - 1
        nq = t_loc["bl_C"].shape[-1]
        out = jnp.zeros((nloc, nring, nq), jnp.float32)
        return synthesis_scan_correlated(
            op, t_loc, roots_rows, key, nloc, fchunk,
            lambda g, z, acc: jax.lax.dynamic_update_slice_in_dim(
                acc, g, z, axis=0
            ),
            out,
        )

    with mesh:
        t_dev = jax.tree.map(
            lambda v, s: jax.device_put(v, NamedSharding(mesh, s)),
            tables, t_specs,
        )
        roots_d = jax.device_put(
            jnp.asarray(roots), NamedSharding(mesh, spec_r)
        )
        return jax.jit(_local)(t_dev, roots_d, key)


def synthesize_cube_sims_sharded(
    op, tables, roots, key, n_sims, mesh,
    fchunk=None, fleg=None, sim_axis="sim", freq_axis=None,
):
    """Independent realisations sharded over the mesh (data parallelism).

    The reference's throughput axis is ``num_sims`` — independent sky
    realisations looped over MPI ranks (reference cora/signal/lss.py:394).
    Here sims are a mesh axis: every device runs the tuned SINGLE-sim
    streamed synthesis program for its own subset of realisations, with
    zero collectives.  The single-device ``--sims`` vmap batches
    realisations *within* one device, where the ring accumulators scale
    with fleg × sims and force fleg down; across devices there is no
    such coupling.

    Per-sim keys are ``fold_in(key, s)`` with the GLOBAL sim index s, so
    the realisations are independent of the device layout: sim s is
    bit-identical whether drawn here, on a different mesh shape, or by a
    single-device :func:`synthesis_scan_correlated` run.

    Parameters
    ----------
    op, tables : SHT operator and its device tables.
    roots : [L, nz, nz] per-ell covariance roots (replicated).
    key : base PRNG key; sim s uses ``fold_in(key, s)``.
    n_sims : total realisation count; divisible by the sim-axis size.
    fleg, fchunk : per-device Legendre / ring frequency chunking (the
        single-sim tuning knobs; default one full sweep).
    freq_axis : optional second mesh axis — shard the frequency rows of
        each sim over it as in :func:`synthesize_cube_sharded` (still
        zero-collective: devices in a freq group regenerate the identical
        white noise from the sim's key).

    Returns
    -------
    [n_sims, nz, nring, nq_max] dense ring-grid cubes, sharded
    (sim × freq) over the first two axes.
    """
    from functools import partial

    from ..healpix.sht import synthesis_scan_correlated

    shard_map = jax.shard_map
    n_sim_dev = mesh.shape[sim_axis]
    if n_sims % n_sim_dev:
        raise ValueError(
            f"n_sims={n_sims} not divisible by sim mesh size {n_sim_dev}"
        )
    sloc = n_sims // n_sim_dev
    L, _, nz = roots.shape
    n_freq_dev = mesh.shape[freq_axis] if freq_axis else 1
    if nz % n_freq_dev:
        raise ValueError(
            f"nz={nz} not divisible by freq mesh size {n_freq_dev}"
        )
    nloc = nz // n_freq_dev
    fleg = min(fleg or nloc, nloc)
    fchunk = min(fchunk or fleg, fleg)

    spec_r = P(None, freq_axis, None)  # freq_axis=None -> replicated
    spec_o = P(sim_axis, freq_axis, None, None)
    # tables may hold tuples of arrays (cached-Λ chunks): spec per leaf
    t_specs = jax.tree.map(lambda v: P(*([None] * jnp.ndim(v))), tables)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(t_specs, spec_r, P()),
        out_specs=spec_o,
        check_vma=False,
    )
    def _local(t_loc, roots_rows, key):
        sidx = jax.lax.axis_index(sim_axis)
        nring = 4 * op.nside - 1
        nq = t_loc["bl_C"].shape[-1]

        def one(s):
            k = jax.random.fold_in(key, sidx * sloc + s)
            out = jnp.zeros((nloc, nring, nq), jnp.float32)
            return synthesis_scan_correlated(
                op, t_loc, roots_rows, k, fleg, fchunk,
                lambda g, z, acc: jax.lax.dynamic_update_slice_in_dim(
                    acc, g, z, axis=0
                ),
                out,
            )

        return jax.lax.map(one, jnp.arange(sloc))

    with mesh:
        t_dev = jax.tree.map(
            lambda v, s: jax.device_put(v, NamedSharding(mesh, s)),
            tables, t_specs,
        )
        roots_d = jax.device_put(
            jnp.asarray(roots), NamedSharding(mesh, spec_r)
        )
        return jax.jit(_local)(t_dev, roots_d, key)


def synthesize_cube_sharded_2d(
    op, tables, roots, key, mesh, fchunk=None,
    freq_axis="freq", band_axis="band",
):
    """Streamed correlated synthesis sharded over a 2-D (freq × band) mesh.

    The Nside ≥ 2048 program (BASELINE stretch row): the single-chip step
    working set exceeds one chip's HBM even in the Λ-free scan mode, so the
    Legendre stage is additionally sharded over RINGS — each device of a
    frequency shard runs the identical scaled/checkpointed λ recurrence on
    its own 1/n_band slice of the northern rings (z_half/lam_mm/lam_k0/
    lam_ck are simply row-sliced; the recurrence is independent per ring).
    This splits every large per-step buffer (the G accumulators, the λ
    carry, the checkpoint table) by n_band with ZERO communication in the
    hot loop: the white-noise draw is regenerated per device from the same
    key (RNG is cheap), exactly like the 1-D frequency sharding.

    One all-gather of the ring-m matrix G per frequency chunk (over the
    inner interconnect axis) reassembles the rings for the (much lighter) ring FFT
    stage, which then runs on a 1/n_band frequency sub-slice per device —
    so the ring stage is also (freq × band)-parallel with no redundancy.

    Reference pattern being replaced: MPI ell-shard → all-to-all →
    freq-shard (cora/core/skysim.py:108-130); here the only collective is
    the G all-gather riding the interconnect.

    Parameters
    ----------
    op : SHT in scan legendre mode (Λ-free; ring-band sharding of the
        cached-Λ mode would slice Λ the same way but is pointless — the
        cached table only exists below the HBM sizes that need 2-D).
    tables : op.tables(False) — host-built device tables.
    roots : [L, nz, nz]; nz divisible by mesh freq size; the local
        frequency count must be divisible by the band size.
    fchunk : ring-stage frequency chunk per device (default: all local).

    Returns
    -------
    [nz, nring, nq_max] dense ring-grid cube, sharded (freq × band) over
    the frequency axis.
    """
    from functools import partial

    shard_map = jax.shard_map
    from ..healpix.sht import (
        _correlated_GeGo_scan,
        _rings_to_grid_parity,
    )

    if "lam" in tables:
        raise ValueError("2-D sharding requires scan (Λ-free) legendre mode")

    n_freq = mesh.shape[freq_axis]
    n_band = mesh.shape[band_axis]
    L, _, nz = roots.shape
    if nz % n_freq:
        raise ValueError(f"nz={nz} not divisible by freq mesh size {n_freq}")
    nloc = nz // n_freq
    if nloc % n_band:
        raise ValueError(
            f"local nz={nloc} not divisible by band mesh size {n_band}"
        )
    fchunk = min(fchunk or nloc, nloc)
    if nloc % fchunk or fchunk % n_band:
        raise ValueError("fchunk must divide local nz and be divisible by "
                         "the band mesh size")
    fsub = fchunk // n_band
    nLb = nloc // n_band

    # Device (f, b) writes, for Legendre chunk i and offset j, the cube row
    # fed-roots row q = f·nloc + i·fchunk + b·fsub + j into output slot
    # s = f·nloc + b·nLb + i·fsub + j (out_specs (freq, band)-major).  Feed
    # the roots rows permuted so slot s carries the TRUE frequency s:
    # fed[:, q(s), :] = roots[:, s, :].  Only the output-row axis is
    # permuted; the latent axis (and hence the realisation and the
    # cross-frequency covariance) is untouched.
    f_, b_, i_, j_ = np.meshgrid(
        np.arange(n_freq), np.arange(n_band),
        np.arange(nloc // fchunk), np.arange(fsub), indexing="ij",
    )
    s_idx = (f_ * nloc + b_ * nLb + i_ * fsub + j_).ravel()
    q_idx = (f_ * nloc + i_ * fchunk + b_ * fsub + j_).ravel()
    roots = np.asarray(roots)
    roots_fed = np.empty_like(roots)
    roots_fed[:, q_idx, :] = roots[:, s_idx, :]

    # table sharding: northern-ring-indexed leaves split over `band`
    ring_axis_of = {"z_half": 0, "lam_mm": 0, "lam_k0": 0, "lam_ck": 2}
    t_specs = {}
    for k_, v in tables.items():
        if k_ in ring_axis_of:
            s = [None] * v.ndim
            s[ring_axis_of[k_]] = band_axis
            t_specs[k_] = P(*s)
        else:
            t_specs[k_] = P(*([None] * v.ndim))

    spec_r = P(None, freq_axis, None)
    spec_o = P((freq_axis, band_axis), None, None)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(t_specs, spec_r, P()),
        out_specs=spec_o,
        check_vma=False,
    )
    def _local(t_loc, roots_rows, key):
        nring = 4 * op.nside - 1
        nq = t_loc["bl_C"].shape[-1]
        bidx = jax.lax.axis_index(band_axis)
        out = jnp.zeros((nLb, nring, nq), jnp.float32)

        def chunk_body(i, acc):
            z0 = i * fchunk
            # Legendre stage on this device's rings, all fchunk freqs
            Ge, Go = _correlated_GeGo_scan(op, t_loc, roots_rows, key,
                                           z0, fchunk)
            # reassemble rings over the inner interconnect axis (~the only
            # collective in the program), then keep 1/n_band of the
            # frequencies for the local ring stage
            Ge = jax.lax.all_gather(
                Ge, band_axis, axis=1, tiled=True)
            Go = jax.lax.all_gather(
                Go, band_axis, axis=1, tiled=True)
            ge = jax.lax.dynamic_slice_in_dim(Ge, bidx * fsub, fsub, axis=0)
            go = jax.lax.dynamic_slice_in_dim(Go, bidx * fsub, fsub, axis=0)
            g = _rings_to_grid_parity(op, t_loc, ge, go)
            return jax.lax.dynamic_update_slice_in_dim(
                acc, g, i * fsub, axis=0
            )

        return jax.lax.fori_loop(0, nloc // fchunk, chunk_body, out)

    with mesh:
        t_dev = {
            k_: jax.device_put(v, NamedSharding(mesh, t_specs[k_]))
            for k_, v in tables.items()
        }
        roots_d = jax.device_put(
            jnp.asarray(roots_fed), NamedSharding(mesh, spec_r)
        )
        return jax.jit(_local)(t_dev, roots_d, key)
