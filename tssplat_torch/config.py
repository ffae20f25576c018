"""Dataclass config validation: the part of ``tssplat_tpu/config.py`` that
``TetMeshGeometry`` needs (the YAML loader and the registries come with the
trainer CLI)."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Type, TypeVar

_T = TypeVar("_T")


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
