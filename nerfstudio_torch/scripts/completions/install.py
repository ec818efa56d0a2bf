"""Shell completions for the port's commands (counterpart of
``nerfstudio_tpu/scripts/completions/install.py``; reference
scripts/completions/install.py):

    python -m nerfstudio_torch.scripts.completions.install [--mode print|install] [--rc-file FILE]

Generates bash completion (compatible with zsh's ``bashcompinit``) for the
port's ``python -m nerfstudio_torch.scripts.*`` commands: the method names
and ``--dataparser`` names for ``train``, the subcommands of ``render``,
``exporter`` and ``process_data``. ``install`` writes it under
``~/.config/nerfstudio_torch/`` and sources it from the rc file."""

from __future__ import annotations

import argparse
from pathlib import Path

# script module -> its subcommands (None: the train script, completed with
# methods and parsers)
COMMANDS = {
    "train": None,
    "eval": [],
    "render": ["camera-path", "interpolate", "spiral", "dataset"],
    "exporter": ["pointcloud", "gaussian-splat", "cameras", "marching-cubes", "tsdf", "poisson", "texture-mesh"],
    "process_data": ["images", "video", "colmap", "polycam", "record3d", "metashape", "realitycapture", "odm"],
    "viewer_script": [],
}
PACKAGE = "nerfstudio_torch.scripts"


def generate_bash() -> str:
    """The completion script: one bash function dispatching on the module
    named after ``python -m``."""
    from nerfstudio_torch.configs.method_configs import method_configs
    from nerfstudio_torch.data.dataparsers.registry import dataparser_registry
    from nerfstudio_torch.plugins import discover_methods

    methods = " ".join(sorted({*method_configs, *discover_methods()}))
    parsers = " ".join(sorted(dataparser_registry()))
    modules = " ".join(f"{PACKAGE}.{m}" for m in COMMANDS)
    lines = [
        "# nerfstudio-torch shell completions (generated)",
        "_nst_torch() {",
        "  local cur=${COMP_WORDS[COMP_CWORD]} prev=${COMP_WORDS[COMP_CWORD-1]} i mod=''",
        "  for ((i = 1; i < COMP_CWORD; i++)); do",
        '    if [[ ${COMP_WORDS[i-1]} == "-m" ]]; then mod=${COMP_WORDS[i]}; break; fi',
        "  done",
        f'  if [[ $prev == "-m" ]]; then COMPREPLY=($(compgen -W "{modules}" -- $cur)); return; fi',
        '  local pos=$((COMP_CWORD - i))',
        '  case $mod in',
        f'    {PACKAGE}.train)',
        f'      if [[ $prev == "--dataparser" ]]; then COMPREPLY=($(compgen -W "{parsers}" -- $cur));',
        f'      elif [[ $pos == 1 ]]; then COMPREPLY=($(compgen -W "{methods}" -- $cur));',
        '      else COMPREPLY=($(compgen -W "--data --dataparser" -- $cur)); fi ;;',
    ]
    for module, subs in COMMANDS.items():
        if subs:
            words = " ".join(subs)
            lines.append(f'    {PACKAGE}.{module}) [[ $pos == 1 ]] && COMPREPLY=($(compgen -W "{words}" -- $cur)) ;;')
    lines += [
        "  esac",
        "}",
        "complete -o default -F _nst_torch python python3",
    ]
    return "\n".join(lines) + "\n"


def entrypoint(argv=None) -> None:
    ap = argparse.ArgumentParser("python -m nerfstudio_torch.scripts.completions.install", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["install", "print"], default="print")
    ap.add_argument("--rc-file", type=Path, default=Path.home() / ".bashrc")
    args = ap.parse_args(argv)
    script = generate_bash()
    if args.mode == "print":
        print(script)
        return
    target = Path.home() / ".config" / "nerfstudio_torch" / "completions.bash"
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(script)
    marker = "# nerfstudio-torch completions"
    rc = args.rc_file
    content = rc.read_text() if rc.exists() else ""
    if marker not in content:
        with open(rc, "a", encoding="utf-8") as f:
            f.write(f"\n{marker}\nsource {target}\n")
    print(f"completions installed: {target} (sourced from {rc})")


if __name__ == "__main__":
    entrypoint()
