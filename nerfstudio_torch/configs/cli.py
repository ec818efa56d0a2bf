"""Dataclass CLI engine — the tyro replacement (counterpart of
``nerfstudio_tpu/configs/cli.py``, the same grammar).

Turns a dataclass tree into dotted ``--a.b.c value`` flags (``python -m
nerfstudio_torch.scripts.train nerfacto --data ... --model.num-levels 8``).
Only the features the reference CLI exercises: nested dataclasses,
Optionals, paths, bools, tuples, enums, and Literal choices."""

from __future__ import annotations

import dataclasses
import enum
import typing
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, get_args, get_origin


def _parse_value(typ, raw: str):
    origin = get_origin(typ)
    if typ is Any:
        return raw
    if origin is typing.Union:
        args = [a for a in get_args(typ) if a is not type(None)]
        if raw.lower() in ("none", "null"):
            return None
        return _parse_value(args[0], raw)
    if origin in (tuple, Tuple):
        inner = get_args(typ)
        parts = [p for p in raw.replace(",", " ").split() if p]
        if len(inner) == 2 and inner[1] is Ellipsis:
            return tuple(_parse_value(inner[0], p) for p in parts)
        return tuple(_parse_value(t, p) for t, p in zip(inner, parts))
    if origin in (list, List):
        inner = get_args(typ)[0]
        return [_parse_value(inner, p) for p in raw.replace(",", " ").split() if p]
    if origin is typing.Literal:
        choices = get_args(typ)
        if raw not in [str(c) for c in choices]:
            raise SystemExit(f"invalid choice {raw!r}; options: {choices}")
        for c in choices:
            if str(c) == raw:
                return c
    if isinstance(typ, type) and issubclass(typ, enum.Enum):
        return typ[raw]
    if typ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    if typ is Path:
        return Path(raw)
    if typ is str:
        return raw
    if dataclasses.is_dataclass(typ):
        raise SystemExit(f"cannot set dataclass field directly: {typ}")
    return raw


def _resolve_field(obj, dotted: str):
    """Walk `a.b.c` to (parent_obj, field, leaf_name)."""
    parts = dotted.split(".")
    cur = obj
    for p in parts[:-1]:
        name = p.replace("-", "_")
        if not hasattr(cur, name):
            raise SystemExit(f"unknown config path: {dotted} (at {p})")
        cur = getattr(cur, name)
    leaf = parts[-1].replace("-", "_")
    if not dataclasses.is_dataclass(cur) or not hasattr(cur, leaf):
        raise SystemExit(f"unknown config field: {dotted}")
    fld = {f.name: f for f in dataclasses.fields(cur)}[leaf]
    return cur, fld, leaf


def apply_overrides(config, argv: List[str]):
    """Apply --dotted.path value overrides in place; returns leftover args."""
    i = 0
    rest = []
    hints_cache: Dict[type, dict] = {}
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            dotted = arg[2:]
            if "=" in dotted:
                dotted, raw = dotted.split("=", 1)
                i += 1
            elif i + 1 < len(argv):
                raw = argv[i + 1]
                i += 2
            else:
                raw = "true"
                i += 1
            parent, fld, leaf = _resolve_field(config, dotted)
            cls = type(parent)
            if cls not in hints_cache:
                hints_cache[cls] = typing.get_type_hints(cls)
            typ = hints_cache[cls].get(leaf, fld.type)
            setattr(parent, leaf, _parse_value(typ, raw))
        else:
            rest.append(arg)
            i += 1
    return rest


def describe(config, prefix: str = "") -> List[str]:
    """Flag listing for --help."""
    lines = []
    for f in dataclasses.fields(config):
        if f.name.startswith("_"):
            continue
        v = getattr(config, f.name)
        name = f"{prefix}{f.name}".replace("_", "-")
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            lines.extend(describe(v, prefix=f"{name}."))
        else:
            lines.append(f"  --{name} (default: {v!r})")
    return lines
