"""Native HEALPix pixelisation and spherical harmonic transforms.

This subpackage replaces the reference's dependency on healpy (C++
healpix_cxx + libsharp; see reference cora/util/hputil.py) with a fully
JAX implementation: pixel geometry as vectorised index arithmetic,
and the SHT as associated-Legendre recurrences + batched ring FFTs
expressed in JAX/XLA.
"""

from .pixel import (  # noqa: F401
    nside2npix,
    npix2nside,
    nside2pixarea,
    nside2resol,
    ring_info,
    pix2ring,
    pix2ang,
    pix2vec,
    ang2pix,
    vec2pix,
    ang2vec,
    vec2ang,
    get_interp_weights,
    get_interp_val,
    get_all_neighbours,
    ud_grade,
    ring2nest,
    nest2ring,
    reorder,
)
