# Copied from lightning_gan_zoo_tpu/config/compose.py (jax-free; kept in step with it by hand).
"""Hydra-compatible YAML config composition.

Re-implements the slice of Hydra 1.1 the reference exercises
(run_network.py:25 ``@hydra.main(config_path="conf", config_name="config")``):

* a primary config with a ``defaults`` list naming group choices
  (conf/config.yaml:64-69: dataset, filepaths, noise_distn, lr_scheduler)
* ``# @package _global_`` headers (every conf/expt/*.yaml, conf/machine/*.yaml)
* package-redirect defaults entries ``/figures@figures.sample_grid: sample_grid``
  (conf/expt/dc_gan.yaml:24-26)
* ``override /group: choice`` entries (conf/expt/hologan.yaml:56-57)
* CLI override grammar:  ``+expt=dc_gan``, ``dataset=mnist``,
  ``train.batch_size=32``, ``calc_fid=False``, ``~key``, ``++key=v``

Composition order matches Hydra: group defaults (in list order) → primary
config body → appended groups (``+expt=``, ``machine=``) each as
(their own defaults → their body) → non-group CLI overrides → interpolation.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Sequence

import yaml

from .node import Config, _deep_merge, resolve_interpolations


class ComposeError(Exception):
    pass


def _yaml_value(text: str) -> Any:
    """Parse a CLI override value with YAML scalar rules ('True', '1e-4', '[a,b]')."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _load_yaml(path: Path) -> tuple[Config, str | None]:
    """Load a YAML file, returning (config, package_directive)."""
    text = path.read_text()
    package = None
    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("# @package"):
            package = stripped.split("# @package", 1)[1].strip()
            break
        if stripped and not stripped.startswith("#"):
            break
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ComposeError(f"{path}: top level must be a mapping")
    return Config(data), package


class _GroupFile:
    def __init__(self, config_dir: Path, group: str, choice: str):
        self.group = group
        self.choice = choice
        self.path = config_dir / group / f"{choice}.yaml"
        if not self.path.exists():
            avail = sorted(p.stem for p in (config_dir / group).glob("*.yaml"))
            raise ComposeError(
                f"Config group '{group}' has no option '{choice}'. "
                f"Available: {avail}"
            )


def _parse_defaults_entry(entry: Any) -> tuple[str, str, str | None, bool]:
    """Return (group, choice, package_override, is_override) for a defaults item.

    Handles:  ``- dataset: celeb_a``
              ``- /figures@figures.sample_grid: sample_grid``
              ``- override /noise_distn: uniform``
              ``- /deformer: tps``
    """
    if not isinstance(entry, dict) or len(entry) != 1:
        raise ComposeError(f"Unsupported defaults entry: {entry!r}")
    key, choice = next(iter(entry.items()))
    key = str(key).strip()
    is_override = False
    if key.startswith("override "):
        is_override = True
        key = key[len("override "):].strip()
    package = None
    if "@" in key:
        key, package = key.split("@", 1)
    group = key.strip().lstrip("/")
    return group, str(choice), package, is_override


class Composer:
    def __init__(self, config_dir: str | Path, config_name: str = "config"):
        self.config_dir = Path(config_dir)
        self.config_name = config_name

    # -- public API --------------------------------------------------------
    def compose(self, overrides: Sequence[str] = ()) -> Config:
        root_path = self.config_dir / f"{self.config_name}.yaml"
        primary, _pkg = _load_yaml(root_path)
        defaults = primary.raw("defaults") or []
        if "defaults" in primary:
            dict.__delitem__(primary, "defaults")
        if "hydra" in primary:  # hydra runtime block — not part of the job config
            dict.__delitem__(primary, "hydra")

        # Parse root defaults list into an ordered group-choice plan.
        plan: list[tuple[str, str, str | None]] = []  # (group, choice, package)
        for entry in defaults:
            group, choice, package, is_override = _parse_defaults_entry(entry)
            if group.startswith("hydra"):
                continue
            if is_override:
                plan = [(g, choice if g == group else c, p) for g, c, p in plan]
            else:
                plan.append((group, choice, package))

        # Split CLI overrides into group selections, appends, and value sets.
        # appends: (+group, choice, package) → composed after primary
        appends: list[tuple[str, str, str | None]] = []
        value_overrides: list[str] = []
        deletions: list[str] = []
        for ov in overrides:
            ov = ov.strip()
            if not ov:
                continue
            if ov.startswith("~"):
                deletions.append(ov[1:])
                continue
            force_add = ov.startswith("++")
            add = ov.startswith("+") and not force_add
            body = ov.lstrip("+")
            if "=" not in body:
                raise ComposeError(f"Override missing '=': {ov!r}")
            key, value = body.split("=", 1)
            key = key.strip()
            if "@" in key:
                # Hydra's package-redirect selection, e.g.
                # ``+figures@figures.azimuth_step=azimuth_step`` — compose
                # <group>/<choice>.yaml into the <package> node (the CLI
                # twin of a ``- /figures@figures.x: y`` defaults entry).
                gpart, pkg = key.split("@", 1)
                gpart = gpart.strip().lstrip("/")
                pkg = pkg.strip()
                if not self._is_group(gpart):
                    # Hydra errors on an unknown group; silently composing a
                    # literal 'group@pkg' value key would drop the intended
                    # callback without a trace
                    avail = sorted(p.name for p in self.config_dir.iterdir()
                                   if p.is_dir())
                    raise ComposeError(
                        f"Package-redirect override {ov!r}: "
                        f"'{gpart}' is not a config group. "
                        f"Available groups: {avail}")
                replaced = False
                for i, (g, _c, p) in enumerate(plan):
                    if g == gpart and p == pkg:
                        plan[i] = (g, value, p)
                        replaced = True
                        break
                if not replaced:
                    appends.append((gpart, value, pkg))
                continue
            if self._is_group(key):
                replaced = False
                for i, (g, _c, p) in enumerate(plan):
                    if g == key:
                        plan[i] = (g, value, p)
                        replaced = True
                        break
                if not replaced:
                    appends.append((key, value, None))
            elif add or force_add:
                value_overrides.append(f"{key}={value}")
            else:
                value_overrides.append(f"{key}={value}")

        cfg = Config()
        # 1. root defaults list, in order
        for group, choice, package in plan:
            self._merge_group(cfg, group, choice, package)
        # 2. primary config body
        _deep_merge(cfg, primary)
        # 3. appended groups (e.g. +expt=dc_gan, machine=small), each with its
        #    own defaults list processed first (figure packages, overrides)
        for group, choice, pkg in appends:
            self._merge_group(cfg, group, choice, package=pkg,
                              replace=True)
        # 4. CLI value overrides
        for ov in value_overrides:
            key, value = ov.split("=", 1)
            cfg.set_dotted(key, _yaml_value(value), merge_dicts=False)
        for key in deletions:
            try:
                cfg.delete_dotted(key)
            except KeyError:
                pass
        # 5. resolve ${...}
        resolve_interpolations(cfg)
        return cfg

    # -- internals -----------------------------------------------------------
    def _is_group(self, key: str) -> bool:
        return "." not in key and (self.config_dir / key).is_dir()

    def _merge_group(self, cfg: Config, group: str, choice: str,
                     package: str | None, replace: bool = False):
        gf = _GroupFile(self.config_dir, group, choice)
        node, file_pkg = _load_yaml(gf.path)
        nested = node.raw("defaults") or []
        if "defaults" in node:
            dict.__delitem__(node, "defaults")

        # A group config's own defaults compose before its body (Hydra order);
        # `override /g: c` entries rewrite an earlier choice already merged
        # into cfg, so re-merge that group at its original package.
        for entry in nested:
            g, c, pkg, is_override = _parse_defaults_entry(entry)
            if g.startswith("hydra"):
                continue
            if is_override and pkg is None:
                # `override /noise_distn: uniform` replaces the previously
                # composed group node wholesale (no stale keys from the old
                # choice may survive — conf/expt/hologan.yaml:56).
                try:
                    cfg.delete_dotted(g)
                except KeyError:
                    pass
            self._merge_group(cfg, g, c, pkg)

        pkg = package if package is not None else file_pkg
        if pkg in (None, "_group_"):
            pkg = group  # default package = group path
        if pkg == "_global_":
            _deep_merge(cfg, node)
        elif replace:
            # CLI group selection replaces the previously composed choice
            # wholesale — stale keys from the old option must not survive
            try:
                cfg.delete_dotted(pkg)
            except KeyError:
                pass
            sub = Config()
            sub.set_dotted(pkg, node)
            _deep_merge(cfg, sub)
        else:
            sub = Config()
            sub.set_dotted(pkg, node)
            _deep_merge(cfg, sub)

    # expose the chosen-choice record for tooling
    def available(self, group: str) -> list[str]:
        return sorted(p.stem for p in (self.config_dir / group).glob("*.yaml"))


def compose(config_dir: str | Path, overrides: Sequence[str] = (),
            config_name: str = "config") -> Config:
    return Composer(config_dir, config_name).compose(overrides)
