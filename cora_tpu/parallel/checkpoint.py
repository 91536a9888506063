"""Sharded checkpoint IO (orbax/tensorstore).

JAX equivalent of the reference's parallel-HDF5 distributed
container IO (reference cora/core/containers.py:90-115 — caput memh5
files flagged ``__memh5_distributed_file``, written collectively over
MPI).  Here the at-scale persistence path is an orbax/tensorstore
checkpoint: every process writes only its own shards (no gather, no
single-writer bottleneck), and the at-rest format is sharding-agnostic —
a restore may request a *different* ``NamedSharding`` than the save used,
so the reference's "read then ``MPIArray.redistribute``" pattern
(reference cora/core/skysim.py:128) collapses into restore itself.

Three tiers:

* :func:`save_sharded` / :func:`restore_sharded` — pytrees of (possibly
  device-sharded) arrays.
* :func:`abstract_like` — build the restore template (ShapeDtypeStruct
  tree with target shardings) from an example tree or explicit specs.
* :func:`save_container` / :func:`load_container` — checkpoint a
  :class:`cora_tpu.core.containers.ContainerBase` whose big datasets may
  live on-device sharded; attrs/index_map ride in a host-side sidecar.
  The memh5-compatible HDF5 export (``ContainerBase.save``,
  ``scripts.makesky.write_map``) remains the ecosystem-interchange
  format; this is the multi-host production form.

Multi-host note: orbax coordinates the commit across processes via the
jax distributed client (``cora_tpu.parallel.distributed.initialize``);
single-process meshes (including the 8-virtual-device CPU test mesh)
need no setup.
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer()


def _as_abstract(leaf, sharding=None):
    """ShapeDtypeStruct mirroring ``leaf``, optionally re-sharded."""
    if sharding is None:
        sharding = getattr(leaf, "sharding", None)
    return jax.ShapeDtypeStruct(
        np.shape(leaf), np.asarray(leaf).dtype if np.isscalar(leaf)
        else leaf.dtype, sharding=sharding
    )


def abstract_like(tree, mesh=None, pspecs=None):
    """Restore template for ``tree``.

    Without ``mesh``, each leaf keeps its current sharding (host numpy
    leaves restore to host).  With ``mesh``, ``pspecs`` gives the target
    ``PartitionSpec`` per leaf — either a single spec applied to every
    leaf or a pytree matching ``tree``'s structure.
    """
    if mesh is None:
        return jax.tree.map(_as_abstract, tree)
    if pspecs is None or isinstance(pspecs, P):
        spec = pspecs if isinstance(pspecs, P) else P()
        return jax.tree.map(
            lambda x: _as_abstract(x, NamedSharding(mesh, spec)), tree
        )
    return jax.tree.map(
        lambda x, s: _as_abstract(
            x, NamedSharding(mesh, s) if isinstance(s, P) else s
        ),
        tree, pspecs,
    )


def save_sharded(path, tree, overwrite=True):
    """Write a pytree of arrays as a sharded checkpoint at ``path``.

    Device-sharded jax arrays are written shard-wise by their owning
    processes; numpy/host leaves are written by process 0.  Blocks until
    the checkpoint is committed (durable on return).
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    ckptr = _checkpointer()
    try:
        ckptr.save(path, tree, force=overwrite)
        ckptr.wait_until_finished()
    finally:
        ckptr.close()
    return path


def restore_sharded(path, like):
    """Restore a checkpoint written by :func:`save_sharded`.

    ``like`` is either an example pytree (concrete arrays — their
    shardings become the target) or a template from
    :func:`abstract_like`.  Each process reads only the byte ranges its
    target shards need, so restoring with a different sharding than the
    save is exactly as cheap as restoring with the same one.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    template = jax.tree.map(
        lambda x: x if isinstance(x, jax.ShapeDtypeStruct) else _as_abstract(x),
        like,
    )
    ckptr = _checkpointer()
    try:
        return ckptr.restore(path, template)
    finally:
        ckptr.close()


# ---------------------------------------------------------------------------
# Container checkpointing
# ---------------------------------------------------------------------------

_META = "container_meta.npz"


def save_container(path, cont, arrays=None, overwrite=True):
    """Checkpoint a ContainerBase with (optionally) device-sharded datasets.

    Parameters
    ----------
    path
        Checkpoint directory (created).
    cont
        The container.  Its ``datasets`` are written via orbax.
    arrays
        Optional ``{name: jax.Array}`` overriding entries of
        ``cont.datasets`` with live device-sharded arrays — the common
        case where the big product of a sharded program is checkpointed
        without ever gathering it to one host.
    """
    path = os.path.abspath(path)
    data = dict(cont.datasets)
    if arrays:
        data.update(arrays)
    save_sharded(os.path.join(path, "datasets"), data, overwrite=overwrite)

    if jax.process_index() == 0:
        meta = {
            "class": type(cont).__module__ + "." + type(cont).__name__,
            "attrs": _encode_attrs(cont.attrs),
            "dataset_attrs": {
                k: _encode_attrs(cont._dataset_attrs(k)) for k in data
            },
        }
        np.savez(
            os.path.join(path, _META),
            meta=np.bytes_(json.dumps(meta).encode()),
            **{f"index_map/{k}": v for k, v in cont.index_map.items()},
        )
    return path


def load_container(path, mesh=None, pspecs=None, cls=None):
    """Restore a container checkpoint written by :func:`save_container`.

    ``mesh``/``pspecs`` choose the target sharding of the datasets (see
    :func:`abstract_like`); by default datasets come back as host
    numpy-backed arrays.  ``pspecs`` maps dataset name -> PartitionSpec
    (missing names restore replicated on the mesh).
    """
    path = os.path.abspath(path)
    with np.load(os.path.join(path, _META), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]))
        index_map = {
            k[len("index_map/"):]: z[k] for k in z.files
            if k.startswith("index_map/")
        }

    if cls is None:
        modname, _, clsname = meta["class"].rpartition(".")
        import importlib

        cls = getattr(importlib.import_module(modname), clsname)

    # discover dataset names/shapes/dtypes from the checkpoint itself
    import orbax.checkpoint as ocp

    ckptr = _checkpointer()
    try:
        ds_path = os.path.join(path, "datasets")
        shapes = ckptr.metadata(ds_path).item_metadata
        template = {}
        for name, m in shapes.items():
            sds = jax.ShapeDtypeStruct(m.shape, m.dtype)
            if mesh is not None:
                spec = (pspecs or {}).get(name, P())
                sds = jax.ShapeDtypeStruct(
                    m.shape, m.dtype, sharding=NamedSharding(mesh, spec)
                )
            template[name] = sds
        data = ckptr.restore(ds_path, template)
    finally:
        ckptr.close()

    self = cls.__new__(cls)
    from ..core.containers import ContainerBase

    ContainerBase.__init__(self, skip_datasets=True)
    self.index_map.update(index_map)
    self.attrs.update(_decode_attrs(meta["attrs"]))
    for name, arr in data.items():
        self.datasets[name] = arr
        self._dataset_attrs(name).update(
            _decode_attrs(meta["dataset_attrs"].get(name, {}))
        )
    if hasattr(self, "_finish_setup"):
        self._finish_setup()
    return self


def _encode_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__nd__": True, "data": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.generic,)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def _decode_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and v.get("__nd__"):
            out[k] = np.asarray(v["data"], dtype=v["dtype"])
        else:
            out[k] = v
    return out
