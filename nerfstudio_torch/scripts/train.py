"""Train a method (counterpart of ``nerfstudio_tpu/scripts/train.py``):

    python -m nerfstudio_torch.scripts.train METHOD --data PATH [--dataparser NAME] [--a.b value ...]

``--machine.device_type cpu`` runs on the CPU; the default is the GPU.
Resume with ``--trainer.load_dir RUN/nerfstudio_models``. The run
directory gets ``config.yml`` (the config as JSON, which YAML readers
read too) and ``config.pkl`` (the config itself, for ``scripts/eval.py``)."""

from __future__ import annotations

import dataclasses
import enum
import json
import pickle
import sys
from pathlib import Path


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    from nerfstudio_torch.configs.cli import apply_overrides, describe
    from nerfstudio_torch.configs.method_configs import descriptions, get_method

    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerfstudio_torch.scripts.train METHOD [--data PATH] [--config.overrides ...]\n")
        print("methods:")
        for name, text in sorted(descriptions.items()):
            print(f"  {name:22s} {text}")
        return
    config = get_method(argv[0])
    argv = argv[1:]
    if "--dataparser" in argv:
        from nerfstudio_torch.data.dataparsers.registry import get_dataparser_config

        i = argv.index("--dataparser")
        config.dataparser = get_dataparser_config(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    rest = apply_overrides(config, argv)
    if rest and rest[0] in ("-h", "--help"):
        print("\n".join(describe(config)))
        return
    if rest:
        raise SystemExit(f"unrecognized arguments: {rest}")
    if config.trainer.experiment_name is None:
        config.trainer.experiment_name = Path(config.data).name if config.data is not None else "unnamed"

    from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig

    base = config.trainer.get_base_dir()
    config.trainer.timestamp = base.name  # one run directory from here on
    if isinstance(config.model, SplatfactoModelConfig):
        from nerfstudio_torch.pipelines.splat_pipeline import train_splat

        save_config(config, base)
        train_splat(config)
        return
    from nerfstudio_torch.pipelines.factory import build_trainer

    trainer = build_trainer(config)
    save_config(config, base)
    trainer.train()


def _to_plain(obj):
    """A config as plain JSON types."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, type):
        return f"{obj.__module__}.{obj.__qualname__}"
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return repr(obj)


def save_config(config, base: Path) -> None:
    """``config.yml`` (JSON) and ``config.pkl`` in the run directory
    (reference train.py:128-139)."""
    base.mkdir(parents=True, exist_ok=True)
    (base / "config.yml").write_text(json.dumps(_to_plain(config), indent=2), encoding="utf-8")
    with open(base / "config.pkl", "wb") as f:
        pickle.dump(config, f)
    print(f"config saved to {base / 'config.yml'}", flush=True)


if __name__ == "__main__":
    main()
