"""Device-placement and compile-cache helpers.

Model *building* (constrained galaxy realisations, Faraday screens,
point-source painting) is small-transform, float64-heavy host work; the
accelerator is for the big synthesis programs.  ``model_device()`` routes
the model-building math to the in-process CPU device when the default
backend is an accelerator, so the full CLI works unchanged inside a GPU
process.
"""

from __future__ import annotations

import contextlib
import os

import jax

# Repository checkout root: the default home of the persistent compile
# cache and of the SHT table cache (both listed in .gitignore).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))


@contextlib.contextmanager
def model_device():
    """Context: run enclosed jax ops on the host CPU device if the
    default backend is an accelerator (no-op on CPU)."""
    if jax.default_backend() == "cpu":
        yield
        return
    with jax.default_device(jax.devices("cpu")[0]):
        yield


@contextlib.contextmanager
def accel_device():
    """Context: escape a :func:`model_device` region back onto the
    accelerator (no-op on CPU backends).  ``jax.default_device`` only
    changes op *placement*, so ``jax.devices()`` still lists the true
    default backend's devices inside a model_device block."""
    if jax.default_backend() == "cpu":
        yield
        return
    with jax.default_device(jax.devices()[0]):
        yield


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``.

    A fixed path: the directory is part of the cache key, so a cache that
    moves between runs never hits."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache():
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    The big synthesis programs take tens of seconds to compile; the
    reference never recompiles anything (its hot loops are AOT Cython /
    libsharp, cora/setup.py:104-129), so repeated invocations reuse
    compiled programs through this cache.  Used by bench.py, the
    cora-makesky CLI and :class:`cora_tpu.pipeline.Pipeline`.  Returns
    the directory.
    """
    cache_dir = compile_cache_dir()
    if jax.config.jax_compilation_cache_dir != cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        # the persistent cache object is created once on first use;
        # re-pointing the directory afterwards requires a reset
        from jax._src import compilation_cache as _cc

        _cc.reset_cache()
    # the default gates (min 1 s compile, min entry size) would skip most
    # of the mid-sized model programs — cache everything
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def on_model_device(fn):
    """Decorator form of :func:`model_device`."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with model_device():
            return fn(*args, **kwargs)

    return wrapper
