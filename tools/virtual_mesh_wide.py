"""Wider-virtual-mesh proof of the Nside>=2048 stretch program.

Runs the 2-D (freq x ring-band) sharded, Lambda-free (checkpointed scan)
synthesis — the exact program shape of the Nside=2048 x 1024-channel
stretch config (reference scaling pattern: cora/core/skysim.py:108-130
ell-shard -> redistribute -> freq-shard, re-designed as a zero-collective
frequency axis plus a ring-band model-parallel axis) — on a 16-device
virtual CPU mesh, twice as wide as the 8-device mesh the test suite and
the driver dryrun use.

Checks agreement with the unsharded streamed synthesis to ~1e-6 relative
(f32 reduction-order differences from the band all-gather; the 1-D
frequency sharding is exactly bit-equal, see tests/test_parallel.py) and
prints the mesh/shard layout and wall time.  Usage:

    python tools/virtual_mesh_wide.py [--nside 128] [--nz 16] \
        [--devices 16] [--mesh 4x4]
"""

import argparse
import os
import sys
import time

p = argparse.ArgumentParser()
p.add_argument("--nside", type=int, default=128)
p.add_argument("--nz", type=int, default=16)
p.add_argument("--devices", type=int, default=16)
p.add_argument("--mesh", default="4x4", help="freq x band mesh shape")
args = p.parse_args()

# force the virtual CPU mesh BEFORE any jax import (this script must be
# run directly; it cannot repair an already-initialised backend)
os.environ["JAX_PLATFORMS"] = "cpu"
xla = os.environ.get("XLA_FLAGS", "")
xla = " ".join(t for t in xla.split()
               if "xla_force_host_platform_device_count" not in t)
os.environ["XLA_FLAGS"] = (
    xla + f" --xla_force_host_platform_device_count={args.devices}"
).strip()

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

# pin the platform on the live config too, before the first backend touch
# (an already-imported plugin may have read the environment first)
jax.config.update("jax_platforms", "cpu")
assert jax.device_count() >= args.devices, jax.devices()

from cora_tpu.healpix.sht import SHT, synthesis_grid_correlated  # noqa: E402
from cora_tpu.parallel.mesh import synthesize_cube_sharded_2d  # noqa: E402

nside, nz = args.nside, args.nz
lmax = 3 * nside - 1
nf, nb = (int(s) for s in args.mesh.split("x"))
assert nf * nb == args.devices

print(f"# devices: {args.devices} virtual CPU; mesh freq={nf} x band={nb}")
print(f"# config: nside={nside} lmax={lmax} nz={nz} (scan mode, Lambda-free)")

t0 = time.time()
op = SHT(nside, lmax, legendre_mode="scan", fft_mode="mm",
         l_chunk=min(64, lmax + 1), scan_ckpt=True)
t = op.tables(False)
assert "lam" not in t  # the Lambda-free mode: nothing table-like scales as L^2 * nring
print(f"# SHT setup: {time.time()-t0:.1f}s")

rng = np.random.RandomState(3)
roots = rng.randn(lmax + 1, nz, nz).astype(np.float32) * 0.1
key = jax.random.PRNGKey(11)

devs = np.array(jax.devices()[: args.devices]).reshape(nf, nb)
mesh = Mesh(devs, ("freq", "band"))
fchunk = nz // nf

t0 = time.time()
cube = synthesize_cube_sharded_2d(op, t, roots, key, mesh, fchunk=fchunk)
cube.block_until_ready()
print(f"# 2-D sharded synthesis ({nf}x{nb}): {time.time()-t0:.1f}s "
      f"shape={cube.shape}")
shards = cube.addressable_shards
print(f"# output sharding: {len(shards)} shards, "
      f"shard shape {shards[0].data.shape}")

t0 = time.time()
ref = np.concatenate(
    [
        np.asarray(
            synthesis_grid_correlated(op, t, jnp.asarray(roots), key, i, fchunk)
        )
        for i in range(0, nz, fchunk)
    ],
    axis=0,
)
print(f"# single-device streamed reference: {time.time()-t0:.1f}s")

cube = np.asarray(cube)
err = np.abs(cube - ref).max() / max(np.abs(ref).max(), 1e-30)
print(f"max rel deviation vs single-device: {err:.3e}")
assert cube.shape == ref.shape
assert err < 1e-6, err
print("WIDE-MESH OK")
