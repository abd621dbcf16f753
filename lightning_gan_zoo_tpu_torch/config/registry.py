"""``_target_`` resolution for the PyTorch package: string → torch factory.

The conf tree names the JAX package's targets (``lightning_gan_zoo_tpu.*``)
and the reference-era aliases. This registry is the port's own — it never
shares the JAX package's module-global dict, whose entries are flax
factories. A target the port has not registered raises
``NotImplementedError``; there is no import fallback, so a config naming an
unported module fails loudly instead of reaching into the JAX package.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable

from .node import Config

_REGISTRY: dict[str, Callable] = {}


class RegistryError(Exception):
    pass


def register(*names: str):
    """Decorator: register a factory under one or more target names."""

    def deco(fn: Callable) -> Callable:
        for name in names:
            _REGISTRY[name] = fn
        return fn

    return deco


def resolve(target: str) -> Callable:
    if not _REGISTRY:
        importlib.import_module("lightning_gan_zoo_tpu_torch.targets")
    if target in _REGISTRY:
        return _REGISTRY[target]
    raise NotImplementedError(
        f"_target_ {target!r} is not yet ported to lightning_gan_zoo_tpu_torch"
        f" (ported targets: {sorted(_REGISTRY)})")


def instantiate(node: Any, *args, **kwargs) -> Any:
    """Mirror of ``hydra.utils.instantiate``: a Config with ``_target_``
    becomes a call of the resolved factory with the remaining keys as
    kwargs."""
    if node is None:
        return None
    if not isinstance(node, Config):
        return node
    if "_target_" not in node:
        raise RegistryError(
            f"instantiate() needs a _target_ key; got {list(node)}")
    fn = resolve(node["_target_"])
    cfg_kwargs = {k: v for k, v in node.items() if k != "_target_"}
    cfg_kwargs.update(kwargs)
    return fn(*args, **cfg_kwargs)
