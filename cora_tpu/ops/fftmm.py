"""Four-step (Bailey) FFT as matmuls.

An alternative to ``jnp.fft`` for the SHT's ring FFTs (``fft_mode="mm"``;
the default is ``jnp.fft``, which was faster on the GPU — PERF.md).  This module implements the DFT of length N = N1·N2 as two small-DFT matmuls and
a twiddle multiply:

    X[k1 + N1 k2] = Σ_{n2} ω_N^{n2 k1} [Σ_{n1} x[n1 N2 + n2] ω_{N1}^{n1 k1}]
                    · ω_{N2}^{n2 k2}

Both contraction steps are matmuls (complex matmuls decompose into four
real matmuls); the twiddle is a fused elementwise multiply.  For the ring
FFT sizes used by the SHT (≤ 16384) this costs ~2·√N MACs per sample —
comfortably faster than memory-bound alternatives at batch sizes of
interest, and portable to any backend.

Twiddle matrices are precomputed host-side and passed in as device tables
(never closure constants).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def _ceinsum(sub, x, W, precision, cmul="xla"):
    """Complex einsum, optionally via 3-multiplication Karatsuba.

    XLA lowers a complex dot to FOUR real dots (rr, ii, ri, ir); the
    Karatsuba/Gauss form needs THREE — p1 = xr·Wr, p2 = xi·Wi,
    p3 = (xr+xi)·(Wr+Wi); re = p1−p2, im = p3−p1−p2 — a 25% matmul-FLOP
    cut on the matmul-FFT stages at the cost of one extra elementwise
    pass over x.  The imaginary part picks up one extra rounding
    (cancellation in p3−p1−p2), same error class as the 4-dot form at
    f32; exactness vs the XLA lowering is asserted in
    tests/test_sht.py.
    """
    if cmul != "karatsuba" or not jnp.iscomplexobj(x):
        return jnp.einsum(sub, x, W, precision=precision)
    xr, xi = jnp.real(x), jnp.imag(x)
    Wr, Wi = jnp.real(W), jnp.imag(W)
    p1 = jnp.einsum(sub, xr, Wr, precision=precision)
    p2 = jnp.einsum(sub, xi, Wi, precision=precision)
    p3 = jnp.einsum(sub, xr + xi, Wr + Wi, precision=precision)
    return jax.lax.complex(p1 - p2, p3 - p1 - p2)


def _split(n):
    """Factor n = n1 * n2 with n1 + n2 minimal (n1, n2 are dense DFT
    matrix sizes, so any factorisation works — not just powers of two).

    The balanced split minimises total MACs (2·(n1+n2) per sample).
    Smooth (2- or 3-smooth) n gives near-square splits; the SHT only
    requests such sizes.
    """
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = d
        d += 1
    assert best is not None and best > 1 or n <= 3, (
        f"fftmm: n={n} has no nontrivial balanced factorisation"
    )
    n1 = max(best, 1)
    n2 = n // n1
    # keep n1 >= n2 (stage-1 contraction over the larger factor)
    return (n2, n1) if n1 < n2 else (n1, n2)


def dft_tables(n, dtype=np.complex64):
    """Precompute twiddle tables for forward and inverse length-n DFTs.

    Returns a dict of host numpy arrays: W1 [n1, n1], T [n1, n2], W2
    [n2, n2] for each direction.
    """
    n1, n2 = _split(n)
    j1 = np.arange(n1)
    j2 = np.arange(n2)

    tabs = {}
    for sign, name in [(-1.0, "fwd"), (+1.0, "inv")]:
        w_n = np.exp(sign * 2j * np.pi / n)
        w1 = np.exp(sign * 2j * np.pi / n1)
        w2 = np.exp(sign * 2j * np.pi / n2)
        tabs[name] = dict(
            W1=(w1 ** (j1[:, None] * j1[None, :])).astype(dtype),  # [n1, k1]
            T=(w_n ** (j1[:, None] * j2[None, :])).astype(dtype),  # [k1, n2]
            W2=(w2 ** (j2[:, None] * j2[None, :])).astype(dtype),  # [n2, k2]
        )
    tabs["n"] = n
    tabs["n1n2"] = (n1, n2)
    return tabs


def _apply(x, tab, n1, n2, precision="highest", in_len=None, out_len=None,
           cmul="xla"):
    """One DFT direction over the last axis of x (length n1*n2).

    ``precision`` guards against reduced-precision matmul passes (TF32
    or bf16): FFT twiddle contractions are precision-critical (the SHT
    accuracy contract is 1e-5 map RMS).

    ``in_len``: statically-known count of (leading) nonzero input samples —
    the stage-1 contraction skips the all-zero trailing rows of the
    [n1, n2] reshape.  ``out_len``: only outputs [0, out_len) are needed —
    the stage-2 contraction computes k2 < ceil(out_len/n1) columns only
    (output index is k1 + n1·k2) and the result is zero-padded back.
    Both are pure matmul-shape reductions (Bluestein convolutions feed
    zero-padded chirps and slice short windows, so ~40% of the work is
    structurally void without these hints).
    """
    shape = x.shape
    xr = x.reshape(shape[:-1] + (n1, n2))
    W1 = tab["W1"]
    if in_len is not None and in_len < n1 * n2:
        n1v = -(-in_len // n2)
        xr = xr[..., :n1v, :]
        W1 = W1[:n1v, :]
    # step 1: DFT over n1 → A[k1, n2]
    A = _ceinsum("...nj,nk->...kj", xr, W1, precision, cmul)
    # step 2: twiddle
    A = A * tab["T"]
    W2 = tab["W2"]
    n2v = n2
    if out_len is not None and out_len < n1 * n2:
        n2v = -(-out_len // n1)
        W2 = W2[:, :n2v]
    # step 3: DFT over n2 → Y[k1, k2]
    Y = _ceinsum("...kj,jl->...kl", A, W2, precision, cmul)
    # output ordering: X[k1 + n1*k2] → transpose to [k2, k1]
    out = jnp.swapaxes(Y, -1, -2).reshape(shape[:-1] + (n1 * n2v,))
    if n2v != n2:
        out = jnp.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, n1 * (n2 - n2v))])
    return out


def permute_kernel(K, n1, n2):
    """Re-layout a frequency-domain conv kernel for :func:`conv_apply`.

    The four-step forward DFT leaves the spectrum in digit-reversed
    order: the flat frequency index is k = k1 + n1·k2 while the natural
    [k1, k2] matrix layout of the intermediate is row-major in k1.  The
    fused convolution keeps the spectrum in that [k1, k2] layout (never
    materialising the flat order), so the kernel table must be permuted
    once, host-side, to match: K2[..., k1, k2] = K[..., k1 + n1·k2].
    """
    K = np.asarray(K)
    return np.ascontiguousarray(
        K.reshape(K.shape[:-1] + (n2, n1)).swapaxes(-1, -2)
    )


def conv_apply(x, ftab, itab, K2, n1, n2, precision="highest",
               in_len=None, out_len=None, cmul="xla"):
    """Fused circular convolution  IDFT(DFT(x) ∘ K) / n  over the last axis.

    The two-step form (``_apply`` forward, kernel multiply, ``_apply``
    inverse) pays two full device-memory copy passes for the digit-reversal
    transposes at the forward's exit and the inverse's entry.  Those
    permutations are inverses of each other: with the inverse four-step
    run on swapped factors (n1' = n2, n2' = n1), the forward's natural
    [k1, k2] intermediate layout IS the inverse's natural input layout.
    Writing out ω_n^{jk} with j = j1·n2 + j2 and k = k1 + n1·k2:

        x[j1, j2] = (1/n) Σ_{k1} ω_{n1}^{j1 k1} ω_n^{j2 k1}
                          Σ_{k2} Y[k1, k2] ω_{n2}^{j2 k2}

    i.e. the inverse is (contract k2 with inv-W2) → (inv twiddle, same
    [k1, j2] layout as the forward's) → (contract k1 with inv-W1), and
    the [j1, j2] result reshapes row-major straight to the flat output.
    Zero transposes end-to-end; the kernel multiply sits between two
    matmuls where XLA fuses it.  Uses the standard fwd/inv tables from
    :func:`dft_tables` unchanged; only K needs :func:`permute_kernel`.

    ``in_len``/``out_len`` are the structural-sparsity hints of
    ``_apply``: leading nonzero input samples (skips zero rows of the
    [n1, n2] reshape) and required leading outputs (j = j1·n2 + j2, so
    only j1 < ceil(out_len/n2) output rows are computed and the result
    is zero-padded back).
    """
    n = n1 * n2
    shape = x.shape
    xr = x.reshape(shape[:-1] + (n1, n2))
    W1 = ftab["W1"]
    if in_len is not None and in_len < n:
        n1v = -(-in_len // n2)
        xr = xr[..., :n1v, :]
        W1 = W1[:n1v, :]
    A = _ceinsum("...nj,nk->...kj", xr, W1, precision, cmul)     # [k1, j2]
    A = A * ftab["T"]
    Y = _ceinsum("...kj,jl->...kl", A, ftab["W2"], precision, cmul)  # [k1, k2]
    Y = Y * K2
    B = _ceinsum("...kc,cj->...kj", Y, itab["W2"], precision, cmul)  # [k1, j2]
    B = B * itab["T"]
    W1i = itab["W1"]
    n1o = n1
    if out_len is not None and out_len < n:
        n1o = -(-out_len // n2)
        W1i = W1i[:, :n1o]
    xo = _ceinsum("...kj,kl->...lj", B, W1i, precision, cmul)    # [j1, j2]
    out = xo.reshape(shape[:-1] + (n1o * n2,))
    if n1o != n1:
        out = jnp.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, (n1 - n1o) * n2)])
    return out / n


def fft_mm(x, tabs):
    """Forward DFT over the last axis using precomputed tables."""
    n1, n2 = tabs["n1n2"]
    t = {k: jnp.asarray(v) for k, v in tabs["fwd"].items()}
    return _apply(x, t, n1, n2)


def ifft_mm(x, tabs):
    """Inverse DFT (normalised by 1/n) over the last axis."""
    n1, n2 = tabs["n1n2"]
    t = {k: jnp.asarray(v) for k, v in tabs["inv"].items()}
    return _apply(x, t, n1, n2) / tabs["n"]
