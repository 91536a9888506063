"""Lightweight task-pipeline framework (caput.pipeline/config equivalent).

The reference drives its LSS synthesis with caput's YAML pipeline runner and
declarative ``config.Property`` task attributes (SURVEY.md L3).  This module
provides the same authoring surface — ``Property``/``enum``/``list_type``
descriptors, ``Task`` with setup/process lifecycle, ``PipelineStopIteration``
and a YAML runner — without MPI: tasks exchange in-memory containers and the
heavy compute inside tasks runs as jitted device programs.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional


logger = logging.getLogger("cora_tpu.pipeline")


class PipelineStopIteration(Exception):
    """Raised by a task's process() to signal it has no more output."""


class ConfigError(Exception):
    """Invalid pipeline configuration."""


class Property:
    """Declarative config attribute (caput.config.Property equivalent)."""

    def __init__(self, proptype: Callable = None, default=None, key=None):
        self.proptype = proptype if proptype is not None else (lambda x: x)
        self.default = default
        self.key = key
        self.name = None

    def __set_name__(self, owner, name):
        self.name = name
        if self.key is None:
            self.key = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.__dict__.get(self.name, self.default)

    def __set__(self, obj, value):
        obj.__dict__[self.name] = value if value is None else self.proptype(value)

    def from_config(self, obj, config):
        if self.key in config:
            self.__set__(obj, config[self.key])


def enum(options, default=None):
    """Config attribute restricted to a set of options."""

    def _check(x):
        if x not in options:
            raise ConfigError(f"Value {x!r} not in allowed options {options}")
        return x

    if default is not None and default not in options:
        raise ConfigError(f"Default {default!r} not in allowed options")
    return Property(proptype=_check, default=default)


def list_type(type_=None, default=None):
    """Config attribute holding a list of a given element type."""

    def _check(x):
        if not isinstance(x, (list, tuple)):
            raise ConfigError(f"Expected a list, got {type(x)}")
        return [type_(v) for v in x] if type_ is not None else list(x)

    return Property(proptype=_check, default=default)


class Task:
    """Base pipeline task.

    Lifecycle: ``from_config`` populates Property attributes, ``setup`` is
    called once with the products of `requires`, then ``process`` is called
    repeatedly with the products of `in` until inputs are exhausted or it
    raises PipelineStopIteration.
    """

    done = False

    def __init__(self):
        self.log = logging.getLogger(
            f"cora_tpu.pipeline.{type(self).__name__}"
        )
        self._count = 0

    @classmethod
    def from_config(cls, config: dict):
        self = cls()
        for klass in type(self).__mro__:
            for name, prop in vars(klass).items():
                if isinstance(prop, Property):
                    prop.from_config(self, config or {})
        return self

    def setup(self, *requires):
        pass

    def process(self, *inputs):
        raise NotImplementedError

    def finish(self):
        pass


class RandomTask(Task):
    """Task with a seeded numpy Generator (caput tasklib.random equivalent)."""

    seed = Property(proptype=int, default=None)

    _rng = None

    @property
    def rng(self):
        import numpy as np

        if self._rng is None:
            self._rng = np.random.default_rng(self.seed)
        return self._rng


# Backwards-compatible aliases matching the reference import structure.
ContainerTask = Task


class Pipeline:
    """Simple in-process DAG pipeline runner.

    Config format mirrors caput's::

        pipeline:
          tasks:
            - type: cora_tpu.signal.lss.CalculateCorrelations
              out: corr
              params: {...}
            - type: cora_tpu.signal.lss.GenerateInitialLSS
              requires: corr
              out: initial
              params: {...}

    Each entry may have `requires` (passed to setup), `in` (queues consumed
    per process call) and `out` (name under which products are published).
    """

    def __init__(self, task_specs: List[dict]):
        self.task_specs = task_specs

    @classmethod
    def from_yaml(cls, path_or_str):
        import os
        import yaml

        if isinstance(path_or_str, str) and os.path.exists(path_or_str):
            with open(path_or_str) as f:
                conf = yaml.safe_load(f)
        else:
            conf = yaml.safe_load(path_or_str)

        tasks = conf["pipeline"]["tasks"] if "pipeline" in conf else conf["tasks"]
        return cls(tasks)

    @staticmethod
    def _resolve(name: str):
        import importlib

        mod, _, klass = name.rpartition(".")
        return getattr(importlib.import_module(mod), klass)

    def run(self) -> dict:
        """Execute the pipeline; returns the dict of named products.

        Products published under each task's `out` name are lists of the
        values produced by successive process() calls.
        """
        products: dict[str, list] = {}

        # compiled task programs survive the process (same cache as the
        # cora-makesky CLI)
        from .util.compute import enable_compile_cache

        enable_compile_cache()

        # instantiate + setup in order
        tasks = []
        for spec in self.task_specs:
            cls = self._resolve(spec["type"])
            task = cls.from_config(spec.get("params", {}))

            requires = spec.get("requires", [])
            if isinstance(requires, str):
                requires = [requires]
            req_products = []
            for rname in requires:
                plist = products.get(rname, [])
                if not plist:
                    raise ConfigError(
                        f"Task {spec['type']} requires {rname!r} which has no "
                        "products yet (tasks run strictly in order)."
                    )
                req_products.append(plist[-1])
            task.setup(*req_products)

            in_keys = spec.get("in", [])
            if isinstance(in_keys, str):
                in_keys = [in_keys]

            out_key = spec.get("out")
            save_to = spec.get("save", None)

            # drive process()
            from .util.profiling import timed

            outputs = []
            try:
                if in_keys:
                    streams = [list(products.get(k, [])) for k in in_keys]
                    for items in zip(*streams):
                        with timed(f"{spec['type']}.process", count=task._count):
                            outputs.append(task.process(*items))
                        task._count += 1
                else:
                    while True:
                        with timed(f"{spec['type']}.process", count=task._count):
                            outputs.append(task.process())
                        task._count += 1
                        if getattr(task, "done", False):
                            break
            except PipelineStopIteration:
                pass

            task.finish()

            if out_key is not None:
                products.setdefault(out_key, []).extend(
                    o for o in outputs if o is not None
                )

            if save_to is not None:
                for i, o in enumerate(outputs):
                    if o is not None and hasattr(o, "save"):
                        fname = save_to.format(count=i)
                        o.save(fname)

            tasks.append(task)

        return products
