"""cora-tpu: JAX simulation framework for low-frequency radio skies.

A ground-up JAX/XLA re-design of the capabilities of
`radiocosmology/cora` (21cm intensity-mapping sky synthesis): angular power
spectra C_l(nu, nu') from cosmological models, correlated Gaussian a_lm
realisations, native spherical-harmonic transforms on HEALPix grids,
foreground models, and a large-scale-structure pipeline — designed for
single-device and multi-device execution via jax.sharding.

Layout
------
- ``cora_tpu.constants`` / ``cora_tpu.cosmology``: background physics.
- ``cora_tpu.util``: splines, bilinear lookup, linalg, FFT helpers.
- ``cora_tpu.healpix``: native HEALPix pixelisation + SHT engine.
- ``cora_tpu.core``: sky synthesis engine (clarray/mkfullsky/maps).
- ``cora_tpu.signal``: 21cm models, correlations, LSS pipeline.
- ``cora_tpu.foreground``: galactic synchrotron, point sources, Poisson.
- ``cora_tpu.parallel``: device-mesh sharding helpers.
- ``cora_tpu.scripts``: the ``cora-makesky`` CLI.
"""

__version__ = "0.1.0"
