"""Config system: OmegaConf-compatible template YAML + per-job JSON overrides
(the port's own copy of mvoc_tpu/config.py, which it does not import).

The reference drives both pipeline stages with an OmegaConf template that uses
``${...}`` interpolation plus a JSON list of per-demo override dicts merged on
top (reference: i2vgen-xl/inverse.py:143, composite.py:94, configs/**).  This
module reimplements exactly the subset of OmegaConf semantics those configs
exercise — deep merge, dotted-path ``${a.b}`` interpolation resolved against
the *merged* root, attribute access, ``to_yaml`` — on PyYAML alone, so the
reference's template.yaml / group_config.json files run unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Iterator, Mapping

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class InterpolationError(Exception):
    """An ``${path}`` reference could not be resolved against the root config."""


class Config:
    """A nested dict with attribute access and lazy ``${path}`` interpolation.

    Interpolations are resolved at *access* time against the root config, so
    values merged later (e.g. ``video_name`` from a JSON entry) retroactively
    affect templated paths such as ``output_dir`` — matching OmegaConf.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: Mapping[str, Any] | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", dict(data or {}))
        object.__setattr__(self, "_root", _root)

    # -- internals -----------------------------------------------------------

    def _root_cfg(self) -> "Config":
        return self._root if self._root is not None else self

    def _resolve(self, value: Any) -> Any:
        if isinstance(value, str):
            return self._resolve_str(value)
        if isinstance(value, dict):
            return Config(value, _root=self._root_cfg())
        if isinstance(value, list):
            return [self._resolve(v) for v in value]
        return value

    def _resolve_str(self, s: str) -> Any:
        full = _INTERP_RE.fullmatch(s)
        if full:  # whole-string interpolation may return a non-str node
            return self._lookup_path(full.group(1))

        def sub(m: re.Match) -> str:
            return str(self._lookup_path(m.group(1)))

        out, n = _INTERP_RE.subn(sub, s)
        # nested interpolation results may themselves contain ${}
        return self._resolve_str(out) if n and _INTERP_RE.search(out) else out

    def _lookup_path(self, path: str) -> Any:
        node: Any = self._root_cfg()
        for part in path.split("."):
            if not isinstance(node, Config) or part not in node:
                raise InterpolationError(
                    f"cannot resolve interpolation '${{{path}}}' (failed at '{part}')"
                )
            node = node[part]
        return node

    # -- mapping protocol ------------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        return self._resolve(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = value._data if isinstance(value, Config) else value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self[k]) for k in self._data)

    def get(self, key: str, default: Any = None) -> Any:
        return self[key] if key in self._data else default

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return to_container(self) == to_container(other)
        if isinstance(other, dict):
            return to_container(self) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


# -- public API (OmegaConf-shaped) ---------------------------------------------


def create(data: Mapping[str, Any] | "Config" | str | None = None) -> Config:
    if isinstance(data, Config):
        return Config(json.loads(json.dumps(to_container(data, resolve=False))))
    if isinstance(data, str):
        return Config(yaml.safe_load(data) or {})
    return Config(data)


def load(path: str) -> Config:
    with open(path) as f:
        return Config(yaml.safe_load(f) or {})


def load_json_list(path: str) -> list[dict]:
    """Load a group_config.json — a list of per-job override dicts."""
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(f"{path}: expected a JSON list of config entries")
    return entries


def merge(*configs: Config | Mapping[str, Any]) -> Config:
    """Deep-merge configs left→right (later values win; dicts merge recursively)."""

    def _merge(base: dict, over: Mapping[str, Any]) -> dict:
        out = dict(base)
        for k, v in over.items():
            if k in out and isinstance(out[k], dict) and isinstance(v, (dict, Config)):
                out[k] = _merge(out[k], v._data if isinstance(v, Config) else v)
            else:
                out[k] = v._data if isinstance(v, Config) else v
        return out

    merged: dict = {}
    for c in configs:
        merged = _merge(merged, c._data if isinstance(c, Config) else c)
    return Config(merged)


def to_container(cfg: Config | Any, resolve: bool = True) -> Any:
    """Convert to plain python containers, resolving interpolations by default."""
    if isinstance(cfg, Config):
        if resolve:
            return {k: to_container(cfg[k], resolve=True) for k in cfg}
        return {k: to_container(v, resolve=False) for k, v in cfg._data.items()}
    if isinstance(cfg, dict):
        return {k: to_container(v, resolve) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_container(v, resolve) for v in cfg]
    return cfg


def to_yaml(cfg: Config) -> str:
    return yaml.safe_dump(to_container(cfg, resolve=False), sort_keys=False)


def check_no_replaceme(cfg: Config, logger=None) -> list[str]:
    """Reference semantics: flag (not fail) fields still carrying 'ReplaceMe'
    sentinels (reference: composite.py:110-114)."""
    bad = [k for k in cfg if "ReplaceMe" in str(to_container(cfg[k]))]
    if logger is not None:
        for k in bad:
            logger.error(f"Field {k} contains 'ReplaceMe'")
    return bad


def dataclass_from_json(cls, path: str):
    """The dataclass `cls` from a JSON object file (a checkpoint's
    config.json); keys that are not fields of `cls` are dropped."""
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in fields})
