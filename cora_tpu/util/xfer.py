"""Host↔device transfers: thin names over ``jax.device_put`` /
``jax.device_get`` that leave arrays already on a device where they are."""

from __future__ import annotations

import numpy as np
import jax


def put(x, device=None):
    """Transfer one array host→device (device arrays pass through)."""
    if isinstance(x, jax.Array):
        return x
    return jax.device_put(np.asarray(x), device)


def put_tree(tree, device=None):
    """Apply :func:`put` to every array leaf of a pytree (e.g. SHT tables)."""
    return jax.tree_util.tree_map(lambda l: put(l, device), tree)


def get(x):
    """Fetch a device array to a writable numpy array."""
    return np.array(jax.device_get(x))
