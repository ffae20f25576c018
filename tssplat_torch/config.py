"""Config system: YAML files + dotted CLI overrides + ``${a.b}``
interpolation, validated into per-component dataclasses, and the
string -> class registries the driver builds its parts from.

The port's own copy of ``tssplat_tpu/config.py`` (capability parity with
the reference's OmegaConf loader, utils/config.py:27-46):
  - ``load_config(path, cli_args=[...])`` merges YAML + CLI ``key.sub=val``
    pairs and resolves ``${dotted.path}`` interpolations (a whole-string
    interpolation keeps the referent's type);
  - ``parse_structured(DataclassType, cfg)`` validates a config subtree into
    a typed dataclass (unknown keys rejected, like OmegaConf.structured);
  - ``ConfigDict`` gives attribute access + ``.get(key, default)``;
  - ``GEOMETRIES`` / ``DATALOADERS`` / ``MATERIALS`` map config names to
    classes (reference geometry/__init__.py:5-12, data/__init__.py:4-13).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Mapping, Optional, Type, TypeVar

import yaml

_T = TypeVar("_T")

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class ConfigDict(dict):
    """Dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key):
        v = dict.__getitem__(self, key)
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            v = ConfigDict(v)
            dict.__setitem__(self, key, v)
        return v

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default


def _parse_scalar(text: str) -> Any:
    """Parse a CLI value string with YAML scalar rules ('true' -> True)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def _get_dotted(cfg: Mapping, dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        node = node[k]
    return node


def _resolve(node: Any, root: Mapping, depth: int = 0) -> Any:
    if depth > 16:
        raise ValueError("config interpolation too deep (cycle?)")
    if isinstance(node, dict):
        return {k: _resolve(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root, depth) for v in node]
    if isinstance(node, str):
        full = _INTERP_RE.fullmatch(node)
        if full:  # whole-string interpolation keeps the referent's type
            return _resolve(_get_dotted(root, full.group(1)), root, depth + 1)

        def sub(m: re.Match) -> str:
            return str(_resolve(_get_dotted(root, m.group(1)), root,
                                depth + 1))

        return _INTERP_RE.sub(sub, node)
    return node


def merge_dicts(base: dict, override: Mapping) -> dict:
    """``base`` with ``override`` merged in, nested mappings recursively."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def load_config(*yaml_paths: str, cli_args: Optional[List[str]] = None,
                from_string: bool = False, **kwargs) -> ConfigDict:
    """Load + merge YAML configs, apply ``a.b.c=value`` CLI overrides,
    resolve ``${...}`` interpolations (reference utils/config.py:37-46)."""
    merged: dict = {}
    for p in yaml_paths:
        if from_string:
            doc = yaml.safe_load(p) or {}
        else:
            with open(p, "r") as f:
                doc = yaml.safe_load(f) or {}
        merged = merge_dicts(merged, doc)
    for arg in cli_args or []:
        if "=" not in arg:
            raise ValueError(f"CLI override must be key=value, got {arg!r}")
        key, _, val = arg.partition("=")
        _set_dotted(merged, key.strip(), _parse_scalar(val))
    if kwargs:
        merged = merge_dicts(merged, kwargs)
    merged = _resolve(merged, merged)
    return ConfigDict(merged)


def dump_config(path: str, cfg: Mapping) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(_plain(cfg), f, sort_keys=False)


def _plain(node: Any) -> Any:
    if isinstance(node, Mapping):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def parse_structured(fields: Type[_T], cfg: Optional[Mapping] = None) -> _T:
    """Validate a config mapping into dataclass ``fields``: unknown keys are
    rejected, defaults filled, nested dataclass fields parsed recursively
    (like ``OmegaConf.structured`` in the reference, utils/config.py:27-29)."""
    cfg = dict(cfg or {})
    if not dataclasses.is_dataclass(fields):
        raise TypeError(f"{fields} is not a dataclass")
    names = {f.name: f for f in dataclasses.fields(fields)}
    unknown = set(cfg) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {fields.__name__}: "
                         f"{sorted(unknown)}")
    kwargs = {}
    for name, f in names.items():
        if name in cfg:
            v = cfg[name]
            if dataclasses.is_dataclass(f.type) and isinstance(v, Mapping):
                v = parse_structured(f.type, v)
            kwargs[name] = v
        elif (f.default is dataclasses.MISSING
              and f.default_factory is dataclasses.MISSING):
            raise ValueError(f"missing required config key {name!r} for "
                             f"{fields.__name__}")
    return fields(**kwargs)


class Registry:
    """Config name -> class."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict = {}

    def register(self, name: str):
        def deco(cls):
            self._entries[name] = cls
            return cls
        return deco

    def __call__(self, name: str):
        if name not in self._entries:
            raise KeyError(f"unknown {self.kind} {name!r}; known: "
                           f"{sorted(self._entries)}")
        return self._entries[name]

    def names(self):
        return sorted(self._entries)


GEOMETRIES = Registry("geometry")
DATALOADERS = Registry("dataloader")
MATERIALS = Registry("material")


def load_geometry(name: str):
    return GEOMETRIES(name)


def load_dataloader(name: str):
    return DATALOADERS(name)


def load_material(name: str):
    return MATERIALS(name)
