"""YAML config composition: defaults chain, interpolation, CLI overrides.

A dependency-free stand-in for the reference's Hydra setup
(``configs/train/*.yaml``): a config file may name parent configs in a
``defaults`` list (composed depth-first, later entries override earlier),
values may reference other keys with ``${a.b.c}`` interpolation, and CLI
arguments of the form ``a.b.c=value`` override anything.

The port's own copy of the JAX package's ``utils/config.py`` (it imports no
JAX either, but the port keeps its own modules).
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Optional, Union

import yaml

_INTERP = re.compile(r"^\$\{([^}]+)\}$")


def deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_one(config_dir: Path, name: str) -> dict:
    path = config_dir / f"{name}.yaml"
    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    defaults = data.pop("defaults", [])
    merged: dict = {}
    for parent in defaults:
        if isinstance(parent, str):
            if parent != "_self_":
                merged = deep_merge(merged, _load_one(config_dir, parent))
        elif isinstance(parent, dict):
            # {group: name} pulls ../<group>/<name>.yaml in under key <group>
            for group, gname in parent.items():
                merged = deep_merge(merged, {group: _load_one(config_dir.parent / group, gname)})
    return deep_merge(merged, data)


def _lookup(config: dict, dotted: str) -> Any:
    node: Any = config
    for part in dotted.split("."):
        node = node[part]
    return node


def _resolve_interpolations(config: dict, root: Optional[dict] = None) -> dict:
    root = root if root is not None else config

    def resolve(value):
        if isinstance(value, str):
            m = _INTERP.match(value)
            if m:
                key = m.group(1)
                if key.startswith("now:"):
                    # ${now:%Y-%m-%d/%H-%M-%S} — per-run output dirs, the
                    # counterpart of hydra's run-dir (reference
                    # default.yaml:158-162). Resolved once per load.
                    import datetime

                    return datetime.datetime.now().strftime(key[4:])
                return resolve(_lookup(root, key))
            return value
        if isinstance(value, dict):
            return {k: resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value

    return resolve(config)


def _parse_override_value(raw: str) -> Any:
    value = yaml.safe_load(raw)
    if isinstance(value, str):
        # YAML 1.1 parses bare scientific notation ("5e-5") as a string;
        # users passing lr=5e-5 on the CLI clearly mean the number
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def apply_overrides(config: dict, overrides: list[str]) -> dict:
    config = copy.deepcopy(config)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like a.b.c=value, got: {ov}")
        key, raw = ov.split("=", 1)
        parts = key.strip().split(".")
        node = config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_override_value(raw)
    return config


def load_config(
    config_dir: Union[str, Path],
    name: str = "default",
    overrides: Optional[list[str]] = None,
) -> dict:
    """Compose ``<config_dir>/<name>.yaml`` with defaults, overrides, interpolation."""
    config = _load_one(Path(config_dir), name)
    if overrides:
        config = apply_overrides(config, overrides)
    return _resolve_interpolations(config)
