"""Transfer helpers: put/put_tree/get round-trip arrays exactly."""

import numpy as np
import jax.numpy as jnp

from cora_tpu.util import xfer


def test_put_complex_roundtrip():
    rng = np.random.RandomState(0)
    x = (rng.randn(7, 33) + 1j * rng.randn(7, 33)).astype(np.complex64)
    d = xfer.put(x)
    assert d.dtype == jnp.complex64
    assert np.array_equal(np.asarray(d), x)
    x128 = x.astype(np.complex128)
    assert np.array_equal(np.asarray(xfer.put(x128)), x128)


def test_put_chunked_large():
    rng = np.random.RandomState(1)
    x = rng.randn(64, 1024, 64).astype(np.float32)  # 16 MB > chunk size
    assert np.array_equal(np.asarray(xfer.put(x)), x)


def test_put_tree_and_passthrough():
    x = np.arange(6.0).reshape(2, 3)
    t = {"a": x, "b": (x + 1j * x).astype(np.complex64)}
    out = xfer.put_tree(t)
    assert np.array_equal(np.asarray(out["a"]), x)
    assert np.array_equal(np.asarray(out["b"]), np.asarray(t["b"]))
    # device arrays pass through untouched
    d = jnp.ones(3)
    assert xfer.put(d) is d


def test_put_scalar_and_int():
    assert np.asarray(xfer.put(np.float32(2.5))) == np.float32(2.5)
    ix = np.arange(10, dtype=np.int32)
    assert np.array_equal(np.asarray(xfer.put(ix)), ix)
