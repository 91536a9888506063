"""On-card smoke test: the sky-synthesis main path on one GPU, at full size.

    python chip_smoke.py              # one card, phases (a)-(f)
    python chip_smoke.py --devices 4  # the sharded paths on four cards

Phases on one card, each compared with the repo's plain reference:

(a) device C_l tables + covariance roots for Corr21cm at Nside=512 × 256
    channels: ‖R Rᵀ − C‖/‖C‖ against the host f64 C_l grid;
(b) the flagship step exactly as bench.py builds it (cached Λ built on the
    device, 256 channels): finite, and each channel's map variance within
    cosmic variance of Σ(2ℓ+1)C_ℓ/4π;
(c) the default get_sht operator at nside 512 (8 channels) against the
    f64 CPU transform (scan Legendre, XLA FFT): map RMS error;
(d) the same for the scan path at nside 1024 (2 channels), plus one timed
    1024 × 64 correlated step;
(e) spin-2 synthesis at nside 512 through get_spin_sht against f64 CPU;
(f) Corr21cm().getsky() at nside 256 × 64 channels.

With --devices 4, only the sharded paths run, each on all four cards and
against its one-card twin: mkfullsky_sharded (256 × 64, map RMS),
zeldovich_sharded (256 × 16 χ) and synthesize_cube_sharded (1024 × 64,
bit-equal to each card's program run in turn on card 0).

The f64 CPU references are computed by a CPU-only child process
(JAX_PLATFORMS=cpu, x64) that runs beside the card's phases and never
touches the card.  The script refuses to run without a GPU and exits
non-zero if any phase fails.  Its last line is one JSON object with the
device as JAX reports it.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

TOL = 1e-5  # map RMS / covariance contract

# Sizes of the phases (a CPU rehearsal at tiny sizes overrides them).
SIZES = dict(sht=512, sht_nz=8, scan=1024, scan_nz=2, scan_step_nz=64,
             spin=512, sky=256, sky_nz=64, cube=1024, cube_nz=64,
             fullsky=256, fullsky_nz=64, za=256, za_nchi=16)


def _test_alm(nside, nz, seed):
    """Fixed numpy a_lm [nz, L, L] with C_l ∝ (l+1)^-2 (m <= l, real m=0)."""
    L = 3 * nside
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((nz, L, L)) + 1j * rng.standard_normal((nz, L, L))
    a *= (1.0 + np.arange(L))[None, :, None] ** -1.0
    a *= np.arange(L)[None, None, :] <= np.arange(L)[None, :, None]
    a[..., 0] = a[..., 0].real
    return a


def _rel_rms(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


# --------------------------------------------------------------- CPU child
def cpu_references(out, sizes):
    """f64 references on the CPU (run in the child process)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cora_tpu.healpix.sht import SHT
    from cora_tpu.healpix.spin import SpinSHT
    from cora_tpu.signal import clfast
    from cora_tpu.signal.corr21cm import Corr21cm

    def save(name, **arrs):
        np.savez(os.path.join(out, name + ".tmp.npz"), **arrs)
        os.replace(os.path.join(out, name + ".tmp.npz"),
                   os.path.join(out, name + ".npz"))

    cfg = json.loads(sizes)
    SIZES.update(cfg["sizes"])
    f = cfg["flagship"]
    freqs = np.linspace(400.0, 800.0, f["nfreq"], endpoint=False)
    th = clfast.build_cl_tables(Corr21cm(), freqs, dtype=np.float64)
    save("cla", cla=clfast.cl_grid_np(th, 3 * f["nside"] - 1))

    def grid(nside, nz, name):
        op = SHT(nside, 3 * nside - 1, legendre_mode="scan", fft_mode="xla")
        save(name, grid=np.asarray(
            op.synthesis_grid(jnp.asarray(_test_alm(nside, nz, nside)))
        ))

    # in the order the card asks for them; the nside-1024 grid is slowest
    grid(SIZES["sht"], SIZES["sht_nz"], "sht")
    ns = SIZES["spin"]
    sop = SpinSHT(ns, 3 * ns - 1, 2)
    e, b = _test_alm(ns, 2, 5)
    q, u = sop.synthesis_grid(jnp.asarray(e), jnp.asarray(b))
    save("spin", q=np.asarray(q), u=np.asarray(u))
    grid(SIZES["scan"], SIZES["scan_nz"], "scan")


class Child:
    """The CPU reference child: started first, waited for per result."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_")
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
                   CUDA_VISIBLE_DEVICES="")
        import bench

        sizes = json.dumps({"sizes": SIZES, "flagship": bench.FLAGSHIP})
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-references",
             self.dir, sizes], env=env,
        )

    def get(self, name, timeout=1200.0):
        path = os.path.join(self.dir, name + ".npz")
        t_end = time.time() + timeout
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                raise RuntimeError(
                    f"CPU reference child exited ({self.proc.returncode}) "
                    f"without {name}")
            if time.time() > t_end:
                raise TimeoutError(f"CPU reference {name} not ready")
            time.sleep(1.0)
        return np.load(path)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


# ------------------------------------------------------------- card phases
class Phases:
    def __init__(self):
        self.results = []

    def run(self, name, fn, *args):
        t0 = time.time()
        try:
            err, tol, info = fn(*args)
            ok = bool(err <= tol)
            line = f"error {err:.3e} tol {tol:.1e}"
        except Exception as e:  # a failed phase fails the run
            traceback.print_exc()
            ok, line, info = False, f"ERROR {type(e).__name__}: {e}", {}
        dt = time.time() - t0
        extra = "".join(f" {k}={v}" for k, v in info.items())
        print(f"phase {name}: {'PASS' if ok else 'FAIL'} {dt:.1f}s {line}"
              f"{extra}", flush=True)
        self.results.append(ok)


def phase_roots(ctx):
    import jax

    import bench

    f = bench.FLAGSHIP
    freqs = np.linspace(400.0, 800.0, f["nfreq"], endpoint=False)
    t0 = time.time()
    roots = bench.device_roots(freqs, 3 * f["nside"] - 1)
    roots.block_until_ready()
    t_dev = time.time() - t0
    ctx["roots"] = roots
    cla = ctx["child"].get("cla")["cla"]
    ctx["cl_diag"] = np.diagonal(cla, axis1=1, axis2=2).T  # [nz, L]
    r = np.asarray(jax.device_get(roots), np.float64)
    rec = np.einsum("lij,lkj->lik", r, r)
    err = float(np.linalg.norm(rec - cla) / np.linalg.norm(cla))
    return err, TOL, {"device_build_s": f"{t_dev:.2f}"}


def phase_flagship(ctx):
    import jax

    import bench

    f = bench.FLAGSHIP
    nside, nz = f["nside"], f["nfreq"]
    t0 = time.time()
    op = bench.build_sht(nside, lchunk=f["lchunk"])
    tables = op.tables(False)
    jax.block_until_ready(tables)
    t_tab = time.time() - t0
    fleg = bench.default_fleg(nside, nz, f["fchunk"], f["fleg"])
    step = jax.jit(bench.make_step(op, nz, fleg, f["fchunk"]))
    roots = ctx["roots"]
    t0 = time.time()
    compiled = step.lower(jax.random.key(0, impl="rbg"), roots,
                          tables).compile()
    t_comp = time.time() - t0
    times = []
    for i in range(3):
        t0 = time.time()
        mom = compiled(jax.random.key(i, impl="rbg"), roots, tables)
        mom = np.asarray(mom.block_until_ready(), np.float64)
        times.append(time.time() - t0)
    if not np.all(np.isfinite(mom)):
        raise RuntimeError("non-finite flagship output")
    # per-channel map variance vs Σ(2ℓ+1)C_ℓ/4π, z-scored by the cosmic
    # variance of the full-sky estimator, Σ 2(2ℓ+1)C_ℓ²/(4π)²
    npix = 12 * nside**2
    var = mom[:, 1] / npix - (mom[:, 0] / npix) ** 2
    cl = ctx["cl_diag"]
    w = 2.0 * np.arange(cl.shape[1]) + 1.0
    expect = (w * cl).sum(1) / (4 * np.pi)
    # the sample variance removes the monopole: drop ℓ=0 from both
    expect -= cl[:, 0] / (4 * np.pi)
    sd = np.sqrt((2.0 * w[1:] * cl[:, 1:] ** 2).sum(1)) / (4 * np.pi)
    z = np.abs(var - expect) / sd
    return float(z.max()), 5.0, {
        "tables_s": f"{t_tab:.2f}", "compile_s": f"{t_comp:.2f}",
        "first_s": f"{times[0]:.3f}",
        "step_s": f"{min(times[1:]):.4f}", "fft": op.fft_mode}


def phase_transform(ctx, nside, nz, name):
    import jax
    import jax.numpy as jnp

    from cora_tpu.healpix.sht import get_sht

    op = get_sht(nside, 3 * nside - 1)
    alm = jnp.asarray(_test_alm(nside, nz, nside).astype(np.complex64))
    t0 = time.time()
    grid = np.asarray(jax.block_until_ready(op.synthesis_grid(alm)))
    dt = time.time() - t0
    err = _rel_rms(grid, ctx["child"].get(name)["grid"])
    return err, TOL, {"mode": f"{op.legendre_mode}/{op.fft_mode}",
                      "first_call_s": f"{dt:.2f}"}


def phase_scan_step(ctx):
    import jax

    import bench
    from cora_tpu.healpix.sht import get_sht

    nside, nz, fchunk = SIZES["scan"], SIZES["scan_step_nz"], 4
    freqs = np.linspace(400.0, 800.0, nz, endpoint=False)
    roots = bench.device_roots(freqs, 3 * nside - 1)
    op = get_sht(nside, 3 * nside - 1)
    tables = op.tables(False)
    fleg = bench.default_fleg(nside, nz, fchunk)
    step = jax.jit(bench.make_step(op, nz, fleg, fchunk))
    t0 = time.time()
    mom = np.asarray(step(jax.random.key(0, impl="rbg"), roots,
                          tables).block_until_ready())
    t_first = time.time() - t0
    t0 = time.time()
    step(jax.random.key(1, impl="rbg"), roots, tables).block_until_ready()
    t_step = time.time() - t0
    finite = bool(np.all(np.isfinite(mom)))
    return (0.0 if finite else np.inf), 0.0, {
        "first_s": f"{t_first:.2f}", "step_s": f"{t_step:.3f}",
        "fleg": fleg, "fchunk": fchunk}


def phase_spin(ctx):
    import jax
    import jax.numpy as jnp

    from cora_tpu.healpix.spin import get_spin_sht

    ns = SIZES["spin"]
    sop = get_spin_sht(ns, 3 * ns - 1, 2)
    e, b = (jnp.asarray(x.astype(np.complex64)) for x in _test_alm(ns, 2, 5))
    t0 = time.time()
    q, u = jax.block_until_ready(sop.synthesis_grid(e, b))
    dt = time.time() - t0
    ref = ctx["child"].get("spin")
    err = max(_rel_rms(q, ref["q"]), _rel_rms(u, ref["u"]))
    return err, TOL, {"first_call_s": f"{dt:.2f}"}


def phase_getsky(ctx):
    import jax

    from cora_tpu.signal.corr21cm import Corr21cm

    cr = Corr21cm()
    nside, nz = SIZES["sky"], SIZES["sky_nz"]
    cr.nside = nside
    cr.frequencies = np.linspace(400.0, 800.0, nz, endpoint=False)
    t0 = time.time()
    sky = cr.getsky(key=jax.random.PRNGKey(0))
    dt = time.time() - t0
    ok = sky.shape == (nz, 12 * nside**2) and np.all(np.isfinite(sky))
    return (0.0 if ok else np.inf), 0.0, {"getsky_s": f"{dt:.2f}",
                                          "std": f"{np.std(sky):.3e}"}


# ------------------------------------------------------------ four cards
def sharded_phases(ph, n):
    """The sharded paths on n cards, each against its one-card twin."""
    import jax
    import jax.numpy as jnp

    import bench
    from cora_tpu.healpix.sht import get_sht, synthesis_scan_correlated
    from cora_tpu.parallel.mesh import (make_mesh, mkfullsky_sharded,
                                        synthesize_cube_sharded)

    mesh = make_mesh(n)

    def spread(x):
        """Devices holding shards of x; fails unless all n hold one (no
        array may sit on device 0 only)."""
        nd = len({s.device for s in x.addressable_shards})
        if nd < n:
            raise RuntimeError(f"output on {nd} of {n} devices")
        return nd

    def cube_1024():
        nside, nz = SIZES["cube"], SIZES["cube_nz"]
        freqs = np.linspace(400.0, 800.0, nz, endpoint=False)
        roots = bench.device_roots(freqs, 3 * nside - 1)
        op = get_sht(nside, 3 * nside - 1)
        t = op.tables(False)
        key = jax.random.PRNGKey(1)
        nloc = nz // n
        t0 = time.time()
        cube = synthesize_cube_sharded(op, t, roots, key, mesh, fchunk=nloc)
        cube.block_until_ready()
        t_shard = time.time() - t0
        nd = spread(cube)
        cube = np.asarray(cube)

        # one-card twin: each card's program (its nloc rows of the roots,
        # the same key) run in turn on card 0 — same shapes, same program
        @jax.jit
        def one_card(t, rows, key):
            out = jnp.zeros((nloc, 4 * nside - 1, t["bl_C"].shape[-1]),
                            jnp.float32)
            return synthesis_scan_correlated(
                op, t, rows, key, nloc, nloc,
                lambda g, z, acc: jax.lax.dynamic_update_slice_in_dim(
                    acc, g, z, axis=0),
                out)

        ref = np.concatenate([
            np.asarray(one_card(t, roots[:, z:z + nloc, :], key))
            for z in range(0, nz, nloc)])
        if not np.all(np.isfinite(ref)):
            raise RuntimeError("non-finite cube")
        err = float(np.abs(cube - ref).max() / np.abs(ref).max())
        return err, 0.0, {"devices": nd, "mode": op.legendre_mode,
                          "sharded_s": f"{t_shard:.1f}"}

    def fullsky_256():
        nside, nz = SIZES["fullsky"], SIZES["fullsky_nz"]
        lmax = 3 * nside - 1
        l = np.arange(lmax + 1, dtype=np.float64)
        x = np.linspace(0.0, 1.0, nz)
        fc = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.05) ** 2)
        corr = ((1.0 + l) ** -2.5)[:, None, None] * fc[None]
        corr = corr.astype(np.float32)
        key = jax.random.PRNGKey(2)
        sky = mkfullsky_sharded(corr, nside, lmax, key, mesh)
        sky.block_until_ready()
        nd = spread(sky)
        one = make_mesh(1)
        ref = np.asarray(mkfullsky_sharded(corr, nside, lmax, key, one))
        err = _rel_rms(np.asarray(sky), ref)
        return err, TOL, {"devices": nd}

    def zeldovich_256():
        from cora_tpu.healpix import transforms as hputil
        from cora_tpu.ops import pmesh
        from cora_tpu.parallel import lss as plss
        from cora_tpu.signal import lssutil

        nside, nchi = SIZES["za"], SIZES["za_nchi"]
        npix = 12 * nside**2
        chi = np.linspace(900.0, 1100.0, nchi)
        rng = np.random.default_rng(42)
        phi = (1e-2 * rng.standard_normal((nchi, npix))).astype(np.float32)
        delta = (0.1 * rng.standard_normal((nchi, npix))).astype(np.float32)
        delta_b = (0.1 * rng.standard_normal((nchi, npix))).astype(np.float32)
        D = 0.5 + 0.5 * rng.random(nchi)
        fr = 0.4 + 0.2 * rng.random(nchi)
        za = plss.zeldovich_sharded(phi, delta, delta_b, chi, D, fr, nside,
                                    mesh, halo=2)
        za.block_until_ready()
        nd = spread(za)
        za = np.asarray(za)
        # stage 1: the sharded gradient against the one-card gradient
        g_s = np.asarray(plss.gradient_sharded(phi, chi, mesh))
        g_r = np.asarray(lssutil.gradient(phi, chi, grad0=True))
        err_g = float(np.abs(g_s - g_r).max() / np.abs(g_r).max())

        # stage 2: the deposit.  Particles start on the χ grid, so bin
        # assignments are discontinuous in the displaced positions: a
        # 1e-7 gradient difference moves mass by ~1e-3 of the peak.  The
        # one-card deposit is therefore fed the sharded gradient, scaled
        # by the same f32 operations as zeldovich_sharded.
        @jax.jit
        def scale(v, Dv, frv, chi_d, sin_t, delta):
            v = v * Dv[None, :, None]
            v = v.at[1].divide(chi_d[:, None])
            v = v.at[2].divide(chi_d[:, None])
            v = v.at[2].divide(sin_t[None, :])
            v = v.at[0].multiply((1.0 + frv)[:, None])
            return v, delta * Dv[:, None]

        f32 = jnp.float32
        theta = hputil.ang_positions(nside)[:, 0]
        psi, dm = scale(jnp.asarray(g_s), jnp.asarray(D, f32),
                        jnp.asarray(fr, f32), jnp.asarray(chi, f32),
                        jnp.asarray(np.sin(theta), f32), jnp.asarray(delta))
        ref = np.asarray(pmesh.za_density_sph(
            psi, jnp.asarray(delta_b), dm, jnp.asarray(chi), nside))
        err_d = float(np.abs(za - ref).max() / np.abs(ref).max())
        return max(err_g, err_d), TOL, {
            "devices": nd, "gradient": f"{err_g:.3e}",
            "deposit": f"{err_d:.3e}"}

    # cheap phases first: the cube builds host scan tables for minutes
    s = SIZES
    ph.run(f"mkfullsky_sharded {s['fullsky']}x{s['fullsky_nz']} ({n} cards"
           ", rms)", fullsky_256)
    ph.run(f"zeldovich_sharded {s['za']}x{s['za_nchi']}chi ({n} cards, max "
           "rel dev of gradient and deposit)", zeldovich_256)
    ph.run(f"synthesize_cube_sharded {s['cube']}x{s['cube_nz']} ({n} cards"
           ", max rel dev, bit-equal)", cube_1024)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="4: run only the sharded paths on four cards")
    p.add_argument("--cpu-references", nargs=2, metavar=("DIR", "SIZES"),
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.cpu_references:
        cpu_references(*args.cpu_references)
        return 0

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: {args.devices} cards asked, {len(devs)} found",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    from cora_tpu.util.compute import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    ph = Phases()
    if args.devices == 4:
        sharded_phases(ph, 4)
    else:
        ctx = {"child": Child()}
        try:
            s = SIZES
            ph.run("a roots Corr21cm flagship (|RR^T-C|/|C|)", phase_roots,
                   ctx)
            if "roots" in ctx:
                ph.run("b flagship step (max |z| of channel variance)",
                       phase_flagship, ctx)
            else:
                ph.results.append(False)
            ctx.pop("roots", None)
            ph.run(f"c get_sht {s['sht']} x{s['sht_nz']} vs f64 CPU (map "
                   "rms)", phase_transform, ctx, s["sht"], s["sht_nz"], "sht")
            ph.run(f"e spin-2 {s['spin']} vs f64 CPU (map rms)", phase_spin,
                   ctx)
            ph.run(f"f Corr21cm.getsky {s['sky']}x{s['sky_nz']} (finite)",
                   phase_getsky, ctx)
            # last: its f64 reference is the CPU child's slowest
            ph.run(f"d scan step {s['scan']}x{s['scan_step_nz']} (finite)",
                   phase_scan_step, ctx)
            ph.run(f"d get_sht {s['scan']} x{s['scan_nz']} vs f64 CPU (map "
                   "rms)", phase_transform, ctx, s["scan"], s["scan_nz"],
                   "scan")
        finally:
            ctx["child"].close()
    if not all(ph.results):
        print(f"chip_smoke: {ph.results.count(False)} phase(s) failed",
              file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
