"""Attribute-access config with ``_KEY`` enum validation (a copy of
``vlsat_tpu/config/config.py``, which imports no JAX).

A dict subclass with attribute access and recursive conversion of nested
dicts; a key ``_KEY: [a, b, ...]`` constrains the sibling ``KEY`` to one of
the listed values.  An experiment JSON written for the JAX package loads
here unchanged (``load_config(path)``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping


class Config(dict):
    def __init__(self, data: Mapping[str, Any] | None = None, **kw):
        super().__init__()
        merged = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = Config(v) if isinstance(v, Mapping) and not isinstance(v, Config) else v
        self._check_enums()

    def _check_enums(self) -> None:
        for k, allowed in list(self.items()):
            if k.startswith("_") and isinstance(allowed, (list, tuple)):
                key = k[1:]
                if key in self and self[key] not in allowed:
                    raise ValueError(
                        f"config key {key}={self[key]!r} not in allowed set {list(allowed)}")

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(f"config has no key {name!r}") from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def merged(self, overrides: Mapping[str, Any]) -> "Config":
        def merge(a, b):
            out = dict(a)
            for k, v in b.items():
                if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                    out[k] = merge(out[k], v)
                else:
                    out[k] = v
            return out

        return Config(merge(self, overrides))

    def to_json(self) -> str:
        def plain(x):
            if isinstance(x, Mapping):
                return {k: plain(v) for k, v in x.items()}
            return x

        return json.dumps(plain(self), indent=2)


def load_config(path: str | Path | None = None,
                overrides: Mapping[str, Any] | None = None) -> Config:
    from vlsat_tpu_torch.config.defaults import DEFAULT_CONFIG

    cfg = Config(DEFAULT_CONFIG)
    if path is not None:
        with open(path) as f:
            cfg = cfg.merged(json.load(f))
    if overrides:
        cfg = cfg.merged(overrides)
    return cfg
