"""Native (C++/OpenMP) host runtime library with ctypes bindings.

Builds ``pixelops.cpp`` into ``build/_pixelops.so`` on first use (g++;
the build directory is listed in .gitignore); every entry point has a
numpy fallback so the package works without a compiler.  This fills the
role of the reference's native layer (Cython/C + OpenMP,
cora/util/pmesh.pyx + pmesh_util.c) for the *host* side of the runtime:
layout conversion for device ring-grid maps, catalogue painting and bulk
pixel math around the JAX compute path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "pixelops.cpp")
_LIB_PATH = os.path.join(_HERE, "build", "_pixelops.so")

_lib = None
_tried = False


def _build():
    """Compile to a temporary file and rename it into place, so processes
    that build at the same time never load a half-written library.
    Generic x86-64 code: the checkout may move between machines."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fno-math-errno", "-fopenmp", "-shared", "-fPIC",
             _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded native library, building it on first use (or None)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(
            _LIB_PATH
        ) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)

        i64 = ctypes.c_int64
        p_d = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        p_f = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        p_i = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.ang2pix_ring.argtypes = [i64, p_d, p_d, p_i, i64]
        lib.pix2ang_ring.argtypes = [i64, p_i, p_d, p_d, i64]
        lib.grid_to_pixels_f32.argtypes = [p_f, p_f, p_i, p_i, i64, i64, i64, i64]
        lib.pixels_to_grid_f32.argtypes = [p_f, p_f, p_i, p_i, i64, i64, i64, i64]
        lib.grid_to_pixels_f64.argtypes = [p_d, p_d, p_i, p_i, i64, i64, i64, i64]
        lib.pixels_to_grid_f64.argtypes = [p_d, p_d, p_i, p_i, i64, i64, i64, i64]
        lib.paint_sources.argtypes = [p_i, p_d, p_d, i64, i64, i64]
        lib.spline_eval_f64.argtypes = [p_d, p_d, p_d, p_d, p_d, i64, i64]
        lib.spline_eval_log_f64.argtypes = [p_d, p_d, p_d, p_d, p_d, i64, i64]

        _lib = lib
    except Exception as exc:  # pragma: no cover - build environment dependent
        sys.stderr.write(f"cora_tpu.native: falling back to numpy ({exc})\n")
        _lib = None
    return _lib


def ang2pix_ring(nside, theta, phi):
    """Vectorised RING ang2pix (native; numpy fallback)."""
    lib = get_lib()
    theta = np.ascontiguousarray(theta, dtype=np.float64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    if lib is None:
        from ..healpix import pixel

        return pixel.ang2pix(nside, theta, phi)
    out = np.empty(theta.shape, dtype=np.int64)
    lib.ang2pix_ring(nside, theta.ravel(), phi.ravel(), out.ravel(), theta.size)
    return out


def pix2ang_ring(nside, ipix):
    """Vectorised RING pix2ang (native; numpy fallback)."""
    lib = get_lib()
    ipix = np.ascontiguousarray(ipix, dtype=np.int64)
    if lib is None:
        from ..healpix import pixel

        return pixel.pix2ang(nside, ipix)
    theta = np.empty(ipix.shape, dtype=np.float64)
    phi = np.empty(ipix.shape, dtype=np.float64)
    lib.pix2ang_ring(nside, ipix.ravel(), theta.ravel(), phi.ravel(), ipix.size)
    return theta, phi


def grid_to_pixels(grid, start, nq, npix):
    """Convert [..., nring, width] ring-grid maps to [..., npix] RING maps."""
    lib = get_lib()
    grid = np.ascontiguousarray(grid)
    nring, width = grid.shape[-2:]
    nmap = int(np.prod(grid.shape[:-2], dtype=np.int64)) if grid.ndim > 2 else 1
    lead = grid.shape[:-2]

    if lib is None or grid.dtype not in (np.float32, np.float64):
        r_of, j_of = _pix_index(start, nq, npix)
        return grid.reshape(nmap, nring, width)[:, r_of, j_of].reshape(
            lead + (npix,)
        )

    start = np.ascontiguousarray(start, dtype=np.int64)
    nq = np.ascontiguousarray(nq, dtype=np.int64)
    out = np.empty(lead + (npix,), dtype=grid.dtype)
    fn = (
        lib.grid_to_pixels_f32 if grid.dtype == np.float32 else lib.grid_to_pixels_f64
    )
    fn(
        grid.reshape(nmap, nring, width).reshape(-1),
        out.reshape(-1),
        start,
        nq,
        nring,
        width,
        npix,
        nmap,
    )
    return out


def pixels_to_grid(pixels, start, nq, width):
    """Convert [..., npix] RING maps to [..., nring, width] ring-grid maps."""
    lib = get_lib()
    pixels = np.ascontiguousarray(pixels)
    npix = pixels.shape[-1]
    nring = len(nq)
    nmap = int(np.prod(pixels.shape[:-1], dtype=np.int64)) if pixels.ndim > 1 else 1
    lead = pixels.shape[:-1]

    if lib is None or pixels.dtype not in (np.float32, np.float64):
        r_of, j_of = _pix_index(start, nq, npix)
        out = np.zeros(lead + (nring, width), dtype=pixels.dtype)
        out.reshape(nmap, nring, width)[:, r_of, j_of] = pixels.reshape(nmap, npix)
        return out

    start = np.ascontiguousarray(start, dtype=np.int64)
    nq = np.ascontiguousarray(nq, dtype=np.int64)
    out = np.empty(lead + (nring, width), dtype=pixels.dtype)
    fn = (
        lib.pixels_to_grid_f32
        if pixels.dtype == np.float32
        else lib.pixels_to_grid_f64
    )
    fn(
        pixels.reshape(-1),
        out.reshape(-1),
        start,
        nq,
        nring,
        width,
        npix,
        nmap,
    )
    return out


def paint_sources(pix, spectra, sky):
    """sky[f, pix[i]] += spectra[i, f] (native OpenMP; numpy fallback)."""
    lib = get_lib()
    pix = np.ascontiguousarray(pix, dtype=np.int64)
    spectra = np.ascontiguousarray(spectra, dtype=np.float64)
    if lib is None:
        np.add.at(sky.T, pix, spectra)
        return sky
    if not sky.flags["C_CONTIGUOUS"] or sky.dtype != np.float64:
        raise ValueError("sky must be C-contiguous float64")
    nsrc, nfreq = spectra.shape
    lib.paint_sources(pix, spectra, sky, nsrc, nfreq, sky.shape[-1])
    return sky


def _pix_index(start, nq, npix):
    nring = len(nq)
    r_of = np.repeat(np.arange(nring), nq)
    j_of = np.arange(npix) - np.asarray(start)[r_of]
    return r_of, j_of


def spline_eval(x_grid, y_grid, y2, pts):
    """Native natural-cubic-spline evaluation; returns None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.empty(pts.shape, dtype=np.float64)
    lib.spline_eval_f64(
        np.ascontiguousarray(x_grid, np.float64),
        np.ascontiguousarray(y_grid, np.float64),
        np.ascontiguousarray(y2, np.float64),
        pts.ravel(), out.ravel(), len(x_grid), pts.size,
    )
    return out


def spline_eval_log(x_grid_log, y_grid_log, y2, pts):
    """Native fused exp(spline(log x)) evaluation; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    out = np.empty(pts.shape, dtype=np.float64)
    lib.spline_eval_log_f64(
        np.ascontiguousarray(x_grid_log, np.float64),
        np.ascontiguousarray(y_grid_log, np.float64),
        np.ascontiguousarray(y2, np.float64),
        pts.ravel(), out.ravel(), len(x_grid_log), pts.size,
    )
    return out
