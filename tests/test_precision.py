"""Every floating dot on the production programs carries an explicit
matmul precision.

On the GPU an f32 dot with no precision may run in TF32 (about three
decimal digits), far outside the 1e-5 map contract, and no CPU test can
see the difference.  These tests walk the jaxprs of the programs instead
and require HIGHEST (the engines' ``op.precision`` default) on every
dot_general with float operands.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import lax
import jax.extend.core as jcore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dots(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            if jnp.issubdtype(eqn.invars[0].aval.dtype, jnp.inexact):
                out.append(eqn)
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dots(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dots(sub, out)
    return out


def _assert_highest(fn, *args):
    dots = _dots(jax.make_jaxpr(fn)(*args).jaxpr, [])
    assert dots, "program has no dots: the walk found nothing to check"
    bad = []
    for eqn in dots:
        prec = eqn.params["precision"]
        precs = prec if isinstance(prec, tuple) else (prec,)
        if any(p != lax.Precision.HIGHEST for p in precs):
            from jax._src import source_info_util

            bad.append(f"{prec}: {source_info_util.summarize(eqn.source_info)}")
    assert not bad, "dots without explicit HIGHEST precision:\n" + "\n".join(bad)


@pytest.mark.parametrize("legmode,fft,cmul", [
    ("cached", "mm", "karatsuba"),
    ("cached", "mm", "xla"),
    ("cached", "xla", "xla"),
    ("scan", "xla", "xla"),
])
def test_flagship_step_dots_are_highest(legmode, fft, cmul):
    """bench's step (_one) at nside 16 in every ring-FFT form, and the
    scan-mode correlated step."""
    bench = _bench()
    nside, nz = 16, 4
    op = bench.build_sht(nside, lchunk=16, legmode=legmode, fft_mode=fft,
                         cmul=cmul)
    t = op.tables(False)
    roots = jnp.asarray(np.random.default_rng(0).standard_normal(
        (3 * nside, nz, nz)).astype(np.float32))
    step = bench.make_step(op, nz, bench.default_fleg(nside, nz, 2), 2)
    _assert_highest(step, jax.random.key(0, impl="rbg"), roots, t)


def test_cl_setup_dots_are_highest():
    """The device C_l tables and covariance roots as production sets them
    up (clfast.device_roots: build_cl_tables_device + cl_roots_device in
    float64)."""
    from cora_tpu.signal import clfast
    from cora_tpu.signal.corr21cm import Corr21cm

    class SmallCorr(Corr21cm):
        _nkperp = 64
        _nkpar = 256

    freqs = np.linspace(400.0, 800.0, 4, endpoint=False)
    _assert_highest(lambda: clfast.device_roots(SmallCorr(), freqs, 15))


def test_spin_and_analysis_dots_are_highest():
    """The f32 spin-2 scan synthesis and the scalar grid analysis."""
    from cora_tpu.healpix import sht
    from cora_tpu.healpix.spin import SpinSHT

    nside = 8
    L = 3 * nside
    sop = SpinSHT(nside, L - 1, 2, l_chunk=8)
    a = jnp.zeros((L, L), jnp.complex64)
    _assert_highest(lambda t, e, b: sop._synthesis_grid_impl(t, e, b),
                    sop.tables(False), a, a)
    op = sht.SHT(nside, L - 1, legendre_mode="scan", l_chunk=8,
                 scan_ckpt=True)
    t = op.tables(False)
    g = jnp.zeros((op.nring, t["bl_C"].shape[-1]), jnp.float32)
    _assert_highest(lambda t, g: sht._analysis_grid(op, t, g, 1), t, g)
