# Copied from lightning_gan_zoo_tpu/config/node.py (jax-free; kept in step with it by hand).
"""Config tree nodes: a light-weight OmegaConf-style container.

The reference drives everything through Hydra/OmegaConf DictConfigs
(run_network.py:25, conf/config.yaml). Neither is installed here, so this
module provides the minimal container semantics the framework needs:

* attribute + item access (``cfg.train.batch_size`` / ``cfg["train"]``)
* a ``MISSING`` sentinel (mandatory values, conf/config.yaml:2,24,28)
* deep merge (later configs override earlier ones, dicts merge recursively)
* ``${a.b.c}`` interpolation resolution, including list indexing such as
  ``${resolution_annealing.resolutions.0}`` (conf/expt/pigan.yaml:29)
"""
from __future__ import annotations

import copy
import re
from typing import Any, Iterator


class MissingValue:
    """Sentinel for mandatory values (OmegaConf's ``MISSING`` / '???')."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "MISSING"

    def __bool__(self):
        return False

    def __deepcopy__(self, memo):
        return self

    def __eq__(self, other):
        return isinstance(other, MissingValue) or other in ("MISSING", "???")

    def __hash__(self):
        return hash("MISSING")


MISSING = MissingValue()


class MissingMandatoryValue(Exception):
    pass


class ConfigAttributeError(AttributeError, KeyError):
    pass


def _is_missing_literal(v: Any) -> bool:
    return isinstance(v, MissingValue) or v == "MISSING" or v == "???"


# PyYAML follows YAML 1.1, which does NOT recognise exponent floats without a
# dot ('2e-4' stays a string). Hydra's grammar does. Coerce those here.
_SCI_FLOAT_RE = re.compile(r"^[-+]?(\.\d+|\d+(\.\d*)?)[eE][-+]?\d+$")


def _coerce_scalar(v: str) -> Any:
    if _SCI_FLOAT_RE.match(v):
        return float(v)
    return v


class Config(dict):
    """A dict with attribute access and recursive wrapping of children."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- wrapping ---------------------------------------------------------
    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, Config):
            return v
        if isinstance(v, dict):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return [Config._wrap(x) for x in v]
        if _is_missing_literal(v):
            return MISSING
        if isinstance(v, str):
            return _coerce_scalar(v)
        return v

    # -- mapping protocol --------------------------------------------------
    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise ConfigAttributeError(f"Config has no key {k!r}")

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise ConfigAttributeError(f"Config has no key {k!r}")

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if isinstance(v, MissingValue):
            raise MissingMandatoryValue(
                f"Mandatory value {k!r} is MISSING — provide it via a config "
                "group (e.g. machine=local) or a CLI override"
            )
        return v

    def get(self, k, default=None):
        try:
            return self[k]
        except (KeyError, MissingMandatoryValue):
            return default

    def is_missing(self, k) -> bool:
        return isinstance(super().get(k), MissingValue)

    def raw(self, k, default=None):
        """Like get() but returns the MISSING sentinel instead of raising."""
        return super().get(k, default)

    def select(self, dotted: str, default=None):
        """Navigate a dotted path ('train.batch_size', 'figures.grid.ncol').
        A MISSING node anywhere along the path yields the MISSING sentinel
        (so interpolations through mandatory values stay mandatory)."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, MissingValue):
                return MISSING
            if isinstance(node, Config):
                if part not in node:
                    return default
                node = node.raw(part)
            elif isinstance(node, list):
                try:
                    node = node[int(part)]
                except (ValueError, IndexError):
                    return default
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any, *, merge_dicts: bool = True):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.raw(part)
            if not isinstance(nxt, Config):
                nxt = Config()
                dict.__setitem__(node, part, nxt)
            node = nxt
        leaf = parts[-1]
        existing = node.raw(leaf)
        if merge_dicts and isinstance(existing, Config) and isinstance(value, (dict, Config)):
            _deep_merge(existing, value)
        else:
            node[leaf] = value

    def delete_dotted(self, dotted: str):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            node = node.raw(part)
            if not isinstance(node, Config):
                raise KeyError(dotted)
        dict.__delitem__(node, parts[-1])

    def to_container(self) -> dict:
        out = {}
        for k in self.keys():
            v = super().__getitem__(k)
            out[k] = _unwrap(v)
        return out

    def copy(self) -> "Config":
        return copy.deepcopy(self)

    def iter_raw(self) -> Iterator[tuple[str, Any]]:
        for k in self.keys():
            yield k, super().__getitem__(k)

    def __deepcopy__(self, memo):
        new = Config()
        for k in self.keys():
            dict.__setitem__(new, k, copy.deepcopy(super().__getitem__(k), memo))
        return new

    def __repr__(self):
        return f"Config({dict.__repr__(self)})"


def _unwrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v.to_container()
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    if isinstance(v, MissingValue):
        return "MISSING"
    return v


def _deep_merge(dst: Config, src: dict) -> Config:
    """Merge ``src`` into ``dst`` in place. Dicts merge recursively; every
    other type (including lists) replaces wholesale — OmegaConf semantics."""
    items = src.iter_raw() if isinstance(src, Config) else src.items()
    for k, v in items:
        cur = dst.raw(k)
        if isinstance(cur, Config) and isinstance(v, (dict, Config)):
            _deep_merge(cur, v)
        else:
            dst[k] = v
    return dst


def merge(*configs: dict) -> Config:
    out = Config()
    for c in configs:
        _deep_merge(out, c)
    return out


# ---------------------------------------------------------------------------
# Interpolation:  "${a.b.c}"  and  "prefix ${x} suffix"
# ---------------------------------------------------------------------------
_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class InterpolationError(Exception):
    pass


def resolve_interpolations(root: Config) -> Config:
    """Resolve all ``${...}`` references in place (with cycle detection)."""

    resolving: set[str] = set()

    def lookup(path: str) -> Any:
        path = path.strip()
        if path in resolving:
            raise InterpolationError(f"Interpolation cycle at ${{{path}}}")
        val = root.select(path, default=_SENTINEL)
        if val is _SENTINEL:
            raise InterpolationError(f"Interpolation key not found: ${{{path}}}")
        if isinstance(val, MissingValue):
            return MISSING
        resolving.add(path)
        try:
            return resolve_value(val)
        finally:
            resolving.discard(path)

    def resolve_value(v: Any) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v.strip())
            if m:  # whole-string interpolation: keep the referent's type
                return lookup(m.group(1))
            if "${" in v:
                return _INTERP_RE.sub(lambda mm: str(lookup(mm.group(1))), v)
            return v
        if isinstance(v, Config):
            for k, child in list(v.iter_raw()):
                dict.__setitem__(v, k, resolve_value(child))
            return v
        if isinstance(v, list):
            return [resolve_value(x) for x in v]
        return v

    _SENTINEL = object()
    resolve_value(root)
    return root
