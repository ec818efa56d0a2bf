"""Method and dataparser plugin discovery (counterpart of
``nerfstudio_tpu/plugins.py``; reference nerfstudio/plugins/registry.py:34-79,
registry_dataparser.py, types.py:25).

Third-party packages register methods through the
``nerfstudio_torch.method_configs`` entry-point group or the
``NERFSTUDIO_TORCH_METHOD_CONFIGS`` environment variable
(``name=module:attr``, comma-separated), and dataparsers through
``nerfstudio_torch.dataparser_configs`` or
``NERFSTUDIO_TORCH_DATAPARSER_CONFIGS``, as the reference's mechanism."""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Any, Dict


@dataclasses.dataclass
class MethodSpecification:
    """(reference plugins/types.py:25-38)"""

    config: Any
    description: str = ""


@dataclasses.dataclass
class DataParserSpecification:
    """(reference plugins/registry_dataparser.py:28-38)"""

    config: Any
    description: str = ""


def _load_entry_points(group: str) -> Dict[str, Any]:
    """{name: config} of the installed packages' entry points in ``group``;
    a plugin that fails to load is reported and skipped."""
    from importlib.metadata import entry_points

    out = {}
    for ep in entry_points(group=group):
        try:
            spec = ep.load()
        except Exception as e:  # noqa: BLE001 — a broken third-party plugin must not stop the CLI
            print(f"[plugins] failed to load {ep.name}: {e!r}", flush=True)
            continue
        out[ep.name] = spec.config if hasattr(spec, "config") else spec
    return out


def _load_env(var: str) -> Dict[str, Any]:
    out = {}
    raw = os.environ.get(var, "")
    for item in filter(None, raw.split(",")):
        name, target = item.split("=", 1)
        module, attr = target.split(":", 1)
        spec = getattr(importlib.import_module(module), attr)
        out[name] = spec.config if hasattr(spec, "config") else spec
    return out


def discover_methods() -> Dict[str, Any]:
    """(reference plugins/registry.py:34-79)"""
    out = _load_entry_points("nerfstudio_torch.method_configs")
    out.update(_load_env("NERFSTUDIO_TORCH_METHOD_CONFIGS"))
    return out


def discover_dataparsers() -> Dict[str, Any]:
    out = _load_entry_points("nerfstudio_torch.dataparser_configs")
    out.update(_load_env("NERFSTUDIO_TORCH_DATAPARSER_CONFIGS"))
    return out
