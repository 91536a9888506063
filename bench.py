"""Benchmark: full 21cm cube synthesis (flagship config Nside=512 × 256 freq).

Steady-state timed step (one jitted device program): correlated a_lm draw
(complex normals × per-ell covariance roots) → cached-Λ Legendre
contraction → foldless Bluestein ring synthesis → dense ring-grid maps →
in-graph scalar reduction.  Setup: channel-integrated C_l tables and
batched per-ell covariance roots (device programs by default on
accelerators), SHT tables, compile.

Run with no arguments it runs the flagship (config 4 of BASELINE.json)
and exits non-zero if that fails.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}; ``vs_baseline`` is the
BASELINE.json target of 5 s for this cube over the measured step.
"""

import argparse
import json
import os
import sys
import time

_T0 = time.time()  # process-start anchor for the cold-to-first-map wall

import numpy as np
import jax
import jax.numpy as jnp

# Flagship: Nside=512 × 256 channels, 400–800 MHz.  fchunk/fleg/lchunk as
# tuned for the cached-Λ path (ROADMAP Speed 4 re-sweeps them).
FLAGSHIP = dict(nside=512, nfreq=256, fchunk=4, fleg=128, lchunk=256)

# Published peaks per device kind (NVIDIA H100 SXM5 data sheet, dense,
# at the 700 W limit).  The step runs f32 matmuls at precision HIGHEST,
# which execute on the CUDA cores, so the FLOP peak is the float32 one
# (not the TF32 or bf16 tensor-core rates).  A device kind that is not
# listed gets no mfu field.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_s": 3.35e12},
}


def peak_for(kind, prec="highest"):
    """Published f32 peak of ``kind`` for a step at matmul precision
    ``prec``, or None when the table has no entry (no mfu then)."""
    if prec != "highest":
        return None
    return PEAKS.get(kind)


def make_step(op, nfreq, fleg, fchunk, xi_dtype=jnp.float32):
    """The timed program: two-level streamed correlated synthesis of the
    whole cube (Legendre stage at fleg frequencies, ring-FFT stage at
    fchunk), folded on device to per-channel map moments [nfreq, 2] =
    (Σ map, Σ map²) over the ring grid, so the cube never exists in
    device memory."""
    from jax import lax

    from cora_tpu.healpix.sht import synthesis_scan_correlated

    def moments(g, z, acc):
        m = jnp.stack([jnp.sum(g, axis=(1, 2)), jnp.sum(g * g, axis=(1, 2))],
                      axis=-1)
        return lax.dynamic_update_slice_in_dim(acc, m, z, axis=0)

    def _one(key, r, t):
        return synthesis_scan_correlated(
            op, t, r, key, fleg, fchunk, moments,
            jnp.zeros((nfreq, 2), jnp.float32), xi_dtype=xi_dtype,
        )

    return _one


def default_fleg(nside, nfreq, fchunk, fleg=None):
    """Legendre-stage width: all frequencies at nside <= 256, else
    2×fchunk unless given; rounded to a divisor of nfreq that fchunk
    divides.  (The flagship passes fleg=128.)"""
    fchunk = min(fchunk, nfreq)
    fleg = min(fleg or (nfreq if nside <= 256 else 2 * fchunk), nfreq)
    fleg = max(fleg - fleg % fchunk, fchunk)
    while nfreq % fleg:
        fleg -= fchunk
    return fleg


def build_sht(nside, *, lchunk, legmode="cached", fft_mode="xla", cmul="xla",
              prec="highest", lambuild="device", ckevery=1, capsub=None,
              cache_dir=None):
    """The flagship SHT operator (ring FFTs through jnp.fft by default, as
    get_sht)."""
    from cora_tpu.healpix.sht import SHT

    lmax = 3 * nside - 1
    cache = (lambda name: os.path.join(cache_dir, name)) if cache_dir else (
        lambda name: None)
    return SHT(nside, lmax, legendre_mode=legmode, fft_mode=fft_mode,
               l_chunk=lchunk, cap_sub=capsub, precision=prec,
               fft_cmul=cmul,
               scan_ckpt=legmode == "scan", ckpt_every=ckevery,
               lambda_build=lambuild,
               ckpt_cache=cache(f"ck_{nside}_{lchunk}_{ckevery}.npz"),
               lambda_cache=cache(f"lam_{nside}_{lchunk}.npz"))


def device_roots(freqs, lmax):
    """Per-ell covariance roots of Corr21cm over ``freqs``, built on the
    device (C_l tables → C_l grid → batched eigh, in f64)."""
    from cora_tpu.signal import clfast
    from cora_tpu.signal.corr21cm import Corr21cm

    return clfast.device_roots(Corr21cm(), freqs, lmax)


def host_roots(freqs, lmax, cache_path=None):
    """Per-ell covariance roots built on the host in f64 (disk-cached)."""
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    from cora_tpu.core.skysim import host_covariance_roots
    from cora_tpu.signal import clfast
    from cora_tpu.signal.corr21cm import Corr21cm

    tables = clfast.build_cl_tables(Corr21cm(), freqs, dtype=np.float64)
    roots = host_covariance_roots(clfast.cl_grid_np(tables, lmax))
    roots = roots.astype(np.float32)
    if cache_path:
        np.save(cache_path, roots)
    return roots


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nside", type=int, default=FLAGSHIP["nside"])
    p.add_argument("--nfreq", type=int, default=FLAGSHIP["nfreq"])
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--fchunk", type=int, default=FLAGSHIP["fchunk"])
    p.add_argument("--fleg", type=int, default=None,
                   help="frequencies per Legendre-stage chunk (default: "
                        "128 at the flagship, else see default_fleg)")
    p.add_argument("--lchunk", type=int, default=FLAGSHIP["lchunk"])
    p.add_argument("--capsub", type=int, default=None,
                   help="frequency sub-batch for the cap Bluestein conv")
    p.add_argument("--legmode", default="cached", choices=["cached", "scan"],
                   help="Legendre stage: cached Λ table or Λ-free "
                        "checkpointed scan (enables Nside >= 1024)")
    p.add_argument("--ckevery", type=int, default=1,
                   help="scan mode: re-seed every k-th ell chunk "
                        "(table 1/k the size)")
    p.add_argument("--xi", default="f32", choices=["f32", "bf16"],
                   help="white-noise draw dtype (bf16 halves the RNG bits "
                        "and is chi^2-valid, tests/test_skysim.py)")
    p.add_argument("--prec", default="highest",
                   choices=["default", "high", "highest"],
                   help="matmul precision for the transform contractions "
                        "(the 1e-5 map contract needs highest)")
    p.add_argument("--fft", default="xla", choices=["mm", "xla"],
                   help="ring FFT form: jnp.fft (cuFFT on the GPU) or "
                        "four-step matmuls")
    p.add_argument("--cmul", default="xla", choices=["xla", "karatsuba"],
                   help="complex-matmul lowering for --fft mm")
    p.add_argument("--lambuild", default="device", choices=["host", "device"],
                   help="cached-Λ table build: 'device' runs the scaled + "
                        "checkpointed recurrence on the device (~1e-6 map "
                        "RMS class), 'host' the exact f64 host build + "
                        "transfer (~2e-7)")
    p.add_argument("--sims", type=int, default=1,
                   help="batched realisations per step (vmap over keys): "
                        "the covariance roots and Λ table are read once "
                        "per sweep for B cubes of work")
    p.add_argument("--roofline", action="store_true",
                   help="also time draw/legendre/ring stages separately "
                        "and report minimum device-memory bytes + GB/s")
    p.add_argument("--setup", default=None, choices=["host", "device"],
                   help="C_l/covariance-roots setup: 'device' builds the "
                        "DCT tables, C_l grid and batched-eigh roots as "
                        "device programs (default on accelerators); "
                        "'host' is the f64 host build (with a "
                        ".bench_cache disk tier)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = p.parse_args()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from cora_tpu.util.compute import CHECKOUT, enable_compile_cache

    print(f"# compile cache: {enable_compile_cache()}", file=sys.stderr)
    dev = jax.devices()[0]
    print(f"# device: {dev} ({dev.device_kind})", file=sys.stderr)

    nside, nfreq = args.nside, args.nfreq
    lmax = 3 * nside - 1
    freqs = np.linspace(400.0, 800.0, nfreq, endpoint=False)
    cache_dir = os.path.join(CHECKOUT, ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)

    setup = {}
    setup_mode = args.setup or ("host" if dev.platform == "cpu" else "device")
    t0 = time.time()
    if setup_mode == "device":
        roots_d = device_roots(freqs, lmax)
    else:
        roots_d = jax.device_put(host_roots(
            freqs, lmax, os.path.join(cache_dir, f"roots_{nside}_{nfreq}.npy")
        ))
    roots_d.block_until_ready()
    setup["roots_s"] = round(time.time() - t0, 3)
    print(f"# covariance roots ({setup_mode}): {setup['roots_s']}s",
          file=sys.stderr)

    t0 = time.time()
    op = build_sht(nside, lchunk=args.lchunk, legmode=args.legmode,
                   fft_mode=args.fft, cmul=args.cmul, prec=args.prec,
                   lambuild=args.lambuild, ckevery=args.ckevery,
                   capsub=args.capsub, cache_dir=cache_dir)
    sht_tables = op.tables(False)
    jax.block_until_ready(sht_tables)
    setup["sht_s"] = round(time.time() - t0, 3)
    print(f"# SHT tables ({op.fft_mode}/{op.fft_cmul}): {setup['sht_s']}s",
          file=sys.stderr)

    fchunk = min(args.fchunk, nfreq)
    fleg_arg = args.fleg
    if fleg_arg is None and (nside, nfreq) == (FLAGSHIP["nside"],
                                               FLAGSHIP["nfreq"]):
        fleg_arg = FLAGSHIP["fleg"]
    fleg = default_fleg(nside, nfreq, fchunk, fleg_arg)
    xi_dtype = jnp.bfloat16 if args.xi == "bf16" else jnp.float32
    _one = make_step(op, nfreq, fleg, fchunk, xi_dtype)

    # rbg: XLA's RngBitGenerator keys (ROADMAP Speed 7 compares impls)
    if args.sims > 1:
        step_fn = jax.jit(jax.vmap(_one, in_axes=(0, None, None)))

        def bench_key(i):
            return jax.random.split(jax.random.key(i, impl="rbg"), args.sims)
    else:
        step_fn = jax.jit(_one)

        def bench_key(i):
            return jax.random.key(i, impl="rbg")

    t0 = time.time()
    compiled = step_fn.lower(bench_key(0), roots_d, sht_tables).compile()
    setup["compile_s"] = round(time.time() - t0, 3)
    print(f"# step compile: {setup['compile_s']}s", file=sys.stderr)

    def step(key):
        return compiled(key, roots_d, sht_tables).block_until_ready()

    t0 = time.time()
    s = float(jnp.sum(step(bench_key(0))))
    setup["warmup_s"] = round(time.time() - t0, 3)
    if not np.isfinite(s):
        raise RuntimeError(f"flagship step produced a non-finite sum {s}")
    # headline setup metric: wall from process start to the first
    # completed map cube
    setup["total_s"] = round(time.time() - _T0, 3)
    print(f"# warmup (first step): {setup['warmup_s']}s sum={s:.3e}; "
          f"cold-to-first-map {setup['total_s']}s", file=sys.stderr)

    times = []
    for i in range(args.repeats):
        t0 = time.time()
        step(bench_key(i + 1))
        times.append(time.time() - t0)
    best = min(times)
    print(f"# times: {['%.4f' % t for t in times]}", file=sys.stderr)

    # --- per-stage times by subtraction (cached mode) -------------------
    # Times cumulative programs (draw; draw+legendre; full step) and
    # reports per-stage time by subtraction, minimum device-memory bytes
    # (_stage_bytes) and achieved GB/s.  Subtraction is approximate when
    # XLA overlaps stages, so per-stage GB/s here are conservative.
    stages = None
    if args.roofline and args.legmode == "cached" and args.sims == 1:
        stages = _stage_times(op, roots_d, sht_tables, bench_key, nfreq,
                              fleg, fchunk, xi_dtype, best)
        print(f"# stages: {stages}", file=sys.stderr)

    # FLOP count: XLA's count of the compiled program, else analytic
    flops = None
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0)) or None
    except Exception as e:  # pragma: no cover - backend-dependent
        print(f"# cost_analysis unavailable: {e}", file=sys.stderr)
    src = "xla"
    if not flops:
        flops = _analytic_flops(op, nfreq, fleg) * args.sims
        src = "analytic"

    per_cube = best / args.sims
    out = {
        "metric": f"full 21cm cube synth (Nside={nside} x {nfreq} freq)",
        "value": round(per_cube, 4),
        "unit": "s",
        "vs_baseline": round(5.0 / per_cube, 3),
        "tflops": round(flops / best / 1e12, 3),
        "flops": int(flops),
        "flops_source": src,
        "fft": f"{op.fft_mode}/{op.fft_cmul}",
        "setup": setup,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if args.sims > 1:
        out["sims"] = args.sims
        out["cubes_per_s"] = round(args.sims / best, 3)
    peak = peak_for(dev.device_kind, args.prec)
    if stages is not None:
        out["stages"] = stages
    if peak:
        out["mfu"] = round(flops / best / peak["f32_flops"], 4)
    print(json.dumps(out))


def _stage_times(op, roots_d, sht_tables, bench_key, nfreq, fleg, fchunk,
                 xi_dtype, best):
    from jax import lax
    from cora_tpu.healpix.sht import _correlated_GeGo, _make_split_draw_blk

    L = op.lmax + 1
    ne = (L + 1) // 2
    meta = op._lam_meta
    roots_p = jnp.concatenate([roots_d[0::2], roots_d[1::2]], axis=0)

    @jax.jit
    def draw_only(key, r, t):
        def sweep(i, acc):
            blk = _make_split_draw_blk(r, key, i * fleg, fleg, nfreq, xi_dtype)
            for c, (parity, sub_lo, nrows, _) in enumerate(meta):
                mw = min(t["lam"][c].shape[0], L)
                off = sub_lo + (0 if parity == 0 else ne)
                acc = acc + jnp.sum(jnp.abs(blk(c, off, nrows, mw)))
            return acc
        return lax.fori_loop(0, nfreq // fleg, sweep, jnp.float32(0.0))

    @jax.jit
    def draw_leg(key, r, t):
        def sweep(i, acc):
            Ge, Go = _correlated_GeGo(op, t, r, key, i * fleg, fleg, xi_dtype)
            return acc + jnp.sum(jnp.abs(Ge)) + jnp.sum(jnp.abs(Go))
        return lax.fori_loop(0, nfreq // fleg, sweep, jnp.float32(0.0))

    def _time(fn):
        fn(bench_key(0), roots_p, sht_tables).block_until_ready()
        ts = []
        for i in range(2):
            t0 = time.time()
            fn(bench_key(i + 1), roots_p, sht_tables).block_until_ready()
            ts.append(time.time() - t0)
        return min(ts)

    t_draw = _time(draw_only)
    t_dl = _time(draw_leg)
    parts = _analytic_parts(op, nfreq, fleg)
    sbytes = _stage_bytes(op, sht_tables, nfreq, fleg, fchunk)
    stages = {}
    for name, ts in [("draw", t_draw), ("legendre", max(t_dl - t_draw, 1e-4)),
                     ("ring", max(best - t_dl, 1e-4))]:
        stages[name] = {
            "s": round(ts, 4),
            "gbytes_min": round(sbytes[name] / 1e9, 2),
            "gbps": round(sbytes[name] / 1e9 / ts, 1),
            "tflops": round(parts[name] / ts / 1e12, 2),
        }
    return stages


def _analytic_parts(op, nfreq, fleg):
    """Per-stage logical real-FLOP count of one full-cube step.

    Convention: one real multiply-add = 2 flops; real λ × complex a_lm
    MAC = 4; complex × complex MAC = 8.
    """
    L = op.lmax + 1
    nh = op.nhalf
    nz = nfreq
    lc = op.l_chunk
    nchunk = -(-L // lc)
    draw = leg = 0.0
    for c in range(nchunk):
        mw = min(L, ((min(L, (c + 1) * lc) + 127) // 128) * 128)
        # draw: roots[lc, fleg, nz](c64) x xi[lc, nz, mw](c64)
        draw += 8.0 * lc * fleg * nz * mw
        # legendre: lam[lc, nh, mw](f32) x alm[fleg, lc, mw](c64)
        leg += 4.0 * lc * nh * fleg * mw
    sweeps = nz / fleg
    # ring stage: per frequency, 2 matmul-FFT applications (fwd+inv) at
    # nfft2, each ~2 matmuls of [nring, n1, n2]-ish cost 8*nring*nfft2*
    # (n1+n2) complex flops (fftmm factorization), plus the W-length
    # equatorial FFTs — approximate with the dominant nfft2 pair
    n1, n2 = op._fft2_n1n2
    nring = 4 * op.nside - 1
    ring = 2 * 8.0 * nring * op.nfft2 * (n1 + n2) * nz
    return {"draw": draw * sweeps, "legendre": leg * sweeps, "ring": ring}


def _analytic_flops(op, nfreq, fleg):
    return sum(_analytic_parts(op, nfreq, fleg).values())


def _stage_bytes(op, t, nfreq, fleg, fchunk):
    """Minimum device-memory traffic per stage of one full-cube step (bytes).

    Counts unavoidable reads/writes of tensors that cannot stay on-chip:
    the ξ white-noise blocks (written by the RNG, read by the draw
    einsum), the covariance-root slices, the per-chunk alm blocks
    (written by the draw, read by the Legendre einsum), the Λ table
    (read once per sweep), the H0/H1 ring accumulators (read+write of
    the chunk's m-window per chunk) and the ring stage's spectrum/grid
    passes (G write+read, ~4 Bluestein passes over the nfft2 spectrum,
    grid write).  Fusion can only reduce these numbers; the achieved
    GB/s computed against them is therefore a LOWER bound.
    """
    L = op.lmax + 1
    nh = op.nhalf
    nz = nfreq
    sweeps = nz / fleg
    xi = alm = lam = acc = 0.0
    for c, (parity, sub_lo, nrows, _) in enumerate(op._lam_meta):
        mw = min(t["lam"][c].shape[0], L)
        xi += nrows * nz * 2 * mw * 4 * 2        # write + read, f32
        alm += fleg * 2 * nrows * mw * 4 * 2     # write + read
        lam += t["lam"][c].nbytes                # read
        acc += 2 * fleg * 2 * nh * mw * 4 * 2    # H0+H1 slice r+w
    roots = L * fleg * nz * 4
    draw = (xi + roots + alm / 2) * sweeps
    leg = (lam + alm / 2 + acc) * sweeps
    nring = 4 * op.nside - 1
    nq = 4 * op.nside
    ring = (
        nring * L * 8 * 2            # G spectrum write + read (c64)
        + 4 * nring * op.nfft2 * 8   # ~4 Bluestein passes over nfft2
        + nring * nq * 4             # grid write (f32)
    ) * nz
    return {"draw": draw, "legendre": leg, "ring": ring}


if __name__ == "__main__":
    main()
