"""Minimal OmegaConf-compatible config system.

A copy of fatezero_tpu/common/config.py (which imports no jax, but its
package does), with one difference: ``instantiate_from_config`` resolves a
``target`` under ``fatezero_tpu.`` to the same dotted path under
``fatezero_tpu_torch.``, since the shipped YAMLs name the JAX package's
pipeline class and this package never imports it.

The reference drives every workload through OmegaConf YAML files with
``target:`` dotted-class-path instantiation and ``${..path}`` relative
interpolation (reference: video_diffusion/common/instantiate_from_config.py:7-33,
config/teaser/jeep_watercolor.yaml:71). omegaconf is not available in this
environment, so this module implements the subset the config schema uses:

  * attribute + item access on nested dicts/lists (``cfg.editing_config.p2p_config``)
  * ``${a.b.c}`` absolute and ``${..a.b}`` relative interpolation
    (each extra leading dot walks one level up from the *containing node*)
  * ``instantiate_from_config({'target': 'pkg.mod.Cls', 'params': {...}})``
  * round-trip save back to YAML (config snapshot in the log dir)
"""
from __future__ import annotations

import importlib
import re
from typing import Any, Iterator, Mapping

import yaml

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(Mapping):
    """Read-mostly attribute-accessible view over a nested dict with interpolation."""

    def __init__(self, data: dict, root: "Config | None" = None, path: tuple = ()):  # noqa: D401
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)
        object.__setattr__(self, "_path", path)

    # -- core access -------------------------------------------------------
    def _wrap(self, key: Any, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, self._root, self._path + (key,))
        if isinstance(value, list):
            return [self._wrap(key, v) for v in value]
        if isinstance(value, str):
            return self._resolve_str(value)
        return value

    def _resolve_str(self, value: str) -> Any:
        """Resolve ${..x.y} interpolations. OmegaConf is lazy, so reference
        configs legally contain DANGLING interpolations on keys nothing ever
        reads (e.g. test_pipeline_config in the teaser configs references a
        validation_sample_logger block that isn't there); those degrade to
        the raw string instead of raising — but a warn-once flags the typo'd
        case so a user config never fails silently downstream."""
        match = _INTERP_RE.fullmatch(value.strip())
        if match:  # whole-string interpolation: preserve the referenced type
            try:
                return self._lookup_interp(match.group(1))
            except (KeyError, TypeError):
                self._warn_dangling(value)
                return value
        if _INTERP_RE.search(value):  # embedded: string substitution
            try:
                return _INTERP_RE.sub(
                    lambda m: str(self._lookup_interp(m.group(1))), value
                )
            except (KeyError, TypeError):
                self._warn_dangling(value)
                return value
        return value

    def _warn_dangling(self, value: str) -> None:
        seen = getattr(self._root, "_warned_interps", None)
        if seen is None:
            seen = set()
            object.__setattr__(self._root, "_warned_interps", seen)
        if value not in seen:
            seen.add(value)
            import logging

            logging.getLogger("fatezero_tpu_torch.config").warning(
                "unresolved config interpolation %r at %s — kept as a raw "
                "string (legal for keys nothing reads; a typo otherwise)",
                value,
                ".".join(map(str, self._path)) or "<root>",
            )

    def _lookup_interp(self, expr: str) -> Any:
        expr = expr.strip()
        ups = 0
        while expr.startswith("."):
            ups += 1
            expr = expr[1:]
        keys = [k for k in expr.split(".") if k]
        if ups == 0:
            node = self._root
        else:
            # OmegaConf semantics: one dot = the containing node, each extra
            # dot walks one parent up. self._path identifies the containing node.
            anchor = self._path[: len(self._path) - (ups - 1)] if ups > 1 else self._path
            node = self._root
            for k in anchor:
                node = node[k]
        for k in keys:
            node = node[k]
        return node

    def __getitem__(self, key):
        data = self._data
        if isinstance(key, str) and key not in data and key.isdigit():
            key = int(key)  # p2p_config.0 style integer keys
        if isinstance(key, str) and key not in data and int_key_present(data, key):
            key = int(key)
        return self._wrap(key, data[key])

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setitem__(self, key, value):
        if isinstance(value, Config):
            value = value.to_dict()
        self._data[key] = value

    def __setattr__(self, key, value):
        self[key] = value

    def __contains__(self, key):
        return key in self._data or (isinstance(key, str) and int_key_present(self._data, key))

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self[k]) for k in self._data]

    def values(self):
        return [self[k] for k in self._data]

    def setdefault(self, key, default=None):
        if key not in self._data:
            self._data[key] = default
        return self[key]

    # -- conversion --------------------------------------------------------
    def to_dict(self, resolve: bool = True) -> dict:
        """Materialize to plain python, resolving interpolations by default."""
        def conv(v):
            if isinstance(v, Config):
                return v.to_dict(resolve)
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v
        if not resolve:
            return _deepcopy_plain(self._data)
        return {k: conv(self[k]) for k in self._data}

    def __repr__(self):
        return f"Config({self._data!r})"


def int_key_present(data: dict, key: str) -> bool:
    try:
        return int(key) in data
    except (ValueError, TypeError):
        return False


def _deepcopy_plain(x):
    if isinstance(x, dict):
        return {k: _deepcopy_plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_deepcopy_plain(v) for v in x]
    return x


class _OmegaFloatLoader(yaml.SafeLoader):
    """YAML 1.1 parses `1e-5` (no dot) as a STRING; OmegaConf patches its
    loader with a wider float resolver so `learning_rate: 1e-5` is a float
    (the tune configs rely on it). Mirror that resolver exactly."""


_OmegaFloatLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_config(path_or_dict) -> Config:
    """Load a YAML file (or wrap a dict) into a Config."""
    if isinstance(path_or_dict, Config):
        return path_or_dict
    if isinstance(path_or_dict, dict):
        return Config(path_or_dict)
    with open(path_or_dict) as f:
        data = yaml.load(f, Loader=_OmegaFloatLoader)
    return Config(data if data is not None else {})


def save_config(cfg, path) -> None:
    data = cfg.to_dict() if isinstance(cfg, Config) else cfg
    with open(path, "w") as f:
        yaml.safe_dump(data, f, sort_keys=False)


JAX_PACKAGE = "fatezero_tpu"
PORT_PACKAGE = "fatezero_tpu_torch"


def port_target(string: str) -> str:
    """A dotted path under the JAX package -> the same path under the port's."""
    head, _, rest = string.partition(".")
    return f"{PORT_PACKAGE}.{rest}" if head == JAX_PACKAGE and rest else string


def get_obj_from_str(string: str, reload: bool = False):
    """Import ``pkg.mod.Attr`` (reference: instantiate_from_config.py:24-33).
    A path under the JAX package resolves to the port's module of that name,
    and raises, naming both paths, where the port has no such attribute."""
    path = port_target(string)
    module, cls = path.rsplit(".", 1)
    try:
        mod = importlib.import_module(module)
        if reload:
            importlib.reload(mod)
        return getattr(mod, cls)
    except (ImportError, AttributeError) as e:
        if path == string:
            raise
        raise ImportError(f"target {string!r} maps to {path!r}, which the port does not have") from e


def instantiate_from_config(config, **extra_kwargs):
    """``{'target': dotted.path, 'params': {...}}`` -> instance.

    Mirrors reference instantiate_from_config.py:7-21, including accepting
    extra keyword arguments that override/augment ``params``.
    """
    if isinstance(config, Config):
        config = config.to_dict()
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params", {}) or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)
