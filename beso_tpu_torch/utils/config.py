"""YAML config tree with hydra-style dotted overrides and ${...} interpolation
(`beso_tpu/utils/config.py` carried over unchanged: it needs only PyYAML).

The reference wires everything through Hydra/OmegaConf defaults-composition
(SURVEY.md 5.6); hydra is deliberately NOT a dependency here — this module
reproduces the pieces the reference actually uses:
* nested YAML configs with `${key}` interpolation across the tree,
* CLI overrides `a.b.c=value` (`--multirun`-style sweeps are a shell loop),
* run-dir config round-trip: every run saves its resolved config, and
  evaluation reloads it to rebuild the exact model
  (scripts/evaluate.py:33-35 behavior).
"""

from __future__ import annotations

import copy
import json
import re
from pathlib import Path
from typing import Any, Iterable, Mapping

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """Nested dict with attribute access and dotted get/set."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def get_path(self, path: str, default=None):
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, path: str, value):
        parts = path.split(".")
        if parts[0] not in self:
            # hydra errors on unknown override keys; a mistyped key here
            # would otherwise be silently accepted and ignored (e.g.
            # `train.max_train_steps=50` against a flat config)
            import logging

            logging.getLogger(__name__).warning(
                "override %r creates a NEW config key %r — the existing "
                "config has no such key; check for a typo (known top-level "
                "keys: %s)", path, parts[0],
                ", ".join(sorted(self.keys())[:40]))
        node = self
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value


def _parse_value(text: str):
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _resolve_interp(node: Any, root: Mapping) -> Any:
    if isinstance(node, str):
        m = _INTERP.fullmatch(node)
        if m:  # whole-string interpolation keeps the referenced type
            ref = Config(root).get_path(m.group(1))
            return _resolve_interp(ref, root) if ref is not None else node
        return _INTERP.sub(
            lambda mm: str(Config(root).get_path(mm.group(1), mm.group(0))), node)
    if isinstance(node, Mapping):
        return {k: _resolve_interp(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(v, root) for v in node]
    return node


def load_config(path, overrides: Iterable[str] = ()) -> Config:
    """Load a YAML config, apply `a.b=v` overrides, resolve ${...}."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config(copy.deepcopy(raw))
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        cfg.set_path(k.strip(), _parse_value(v.strip()))
    resolved = _resolve_interp(dict(cfg), cfg)
    return Config(resolved)


def save_config(cfg: Mapping, directory, name: str = "config.yaml") -> Path:
    """Persist the resolved config into the run dir (hydra-style round-trip)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    out = d / name
    with open(out, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(dict(cfg))), f, sort_keys=False)
    return out
