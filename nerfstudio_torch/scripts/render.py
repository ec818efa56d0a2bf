"""Render a trained run along a camera path to frames or a video
(counterpart of ``nerfstudio_tpu/scripts/render.py``):

    python -m nerfstudio_torch.scripts.render {camera-path,interpolate,spiral,dataset} --load-config RUN_DIR
        [--camera-path-filename PATH.json] [--output-path renders/output.mp4]
        [--rendered-output-names rgb,depth] [--steps N] [--fps 24]

``camera-path`` reads the viewer's keyframe JSON, ``interpolate`` runs
through the train cameras (``--steps`` per transition, 10), ``spiral``
circles the first eval camera (``--steps`` 30, radius 0.1), ``dataset``
takes the eval cameras. A ray method renders each frame through
``pipeline.render_camera`` (under the eval background), splatfacto through
its rasterizer at the full SH degree, on the device the run's config
names. Each frame puts the named outputs side by side; ``depth`` goes
through the turbo depth colormap composited by accumulation.

Frames: a ``.mp4`` or ``.gif`` output goes through ``imageio`` where it
imports and has a writer for the suffix; otherwise, and for any other
output path, every frame is a PNG (``data/image_io.write_png``) in a
directory named by the output path, and a line says so."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

FLAGS = ("--load-config", "--camera-path-filename", "--output-path", "--rendered-output-names", "--steps", "--fps")
VIDEO_SUFFIXES = (".mp4", ".gif")


def write_frames(frames: List[np.ndarray], output_path: Path, fps: int = 24) -> Path:
    """Write (H, W, 3) uint8 frames (reference :14-31); returns where they went."""
    from nerfstudio_torch.data.image_io import write_png

    output_path.parent.mkdir(parents=True, exist_ok=True)
    if output_path.suffix in VIDEO_SUFFIXES:
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(output_path, frames, fps=fps)
            print(f"wrote {len(frames)} frames to {output_path}", flush=True)
            return output_path
        except (ImportError, ValueError, RuntimeError, OSError) as err:
            if output_path.is_file():
                output_path.unlink()
            print(f"no {output_path.suffix} writer ({type(err).__name__}: {err}); writing PNG frames into the "
                  f"directory {output_path} instead", flush=True)
    output_path.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        write_png(output_path / f"{i:05d}.png", f)
    print(f"wrote {len(frames)} frames to {output_path}", flush=True)
    return output_path


def render_outputs(config, pipeline, state, cameras, i: int) -> Dict[str, torch.Tensor]:
    """Camera ``i``'s outputs (H, W, C) on the run's device."""
    from nerfstudio_torch.models.splatfacto import SplatfactoModelConfig

    if isinstance(config.model, SplatfactoModelConfig):
        c2w, K, w, h = pipeline.camera(cameras, i)
        with torch.no_grad():
            return pipeline.model.render(state.params, state.aux.alive, c2w, K, w, h,
                                         sh_degree_active=config.model.sh_degree)
    return pipeline.render_camera(state, cameras, i)


def render_frames(config, pipeline, state, cameras, rendered_output_names: Sequence[str] = ("rgb",)):
    """Every camera's frame as (H, W * len(names), 3) uint8 (reference
    :34-67)."""
    from nerfstudio_torch.utils.colormaps import apply_depth_colormap

    frames = []
    for i in range(len(cameras)):
        out = render_outputs(config, pipeline, state, cameras, i)
        pieces = []
        for name in rendered_output_names:
            img = apply_depth_colormap(out["depth"], out.get("accumulation")) if name == "depth" else out[name]
            if img.shape[-1] == 1:
                img = img.repeat_interleave(3, dim=-1)
            pieces.append(img)
        frame = torch.cat(pieces, dim=1)
        frames.append((torch.clamp(frame, 0, 1) * 255).to(torch.uint8).cpu().numpy())
    return frames


def path_cameras(mode: str, args: Dict[str, str], config, pipeline):
    """The cameras of a render mode (reference :88-106)."""
    from nerfstudio_torch.cameras import camera_paths

    dm = pipeline.datamanager
    if mode == "camera-path":
        with open(args["--camera-path-filename"], encoding="utf-8") as f:
            return camera_paths.get_path_from_json(json.load(f), device=config.machine.device())
    if mode == "interpolate":
        return camera_paths.get_interpolated_camera_path(dm.train_cameras, steps=int(args.get("--steps", "10")))
    if mode == "spiral":
        return camera_paths.get_spiral_path(dm.eval_cameras, steps=int(args.get("--steps", "30")), radius=0.1)
    if mode == "dataset":
        return dm.eval_cameras
    raise SystemExit(f"unknown mode {mode}")


def main(argv=None) -> dict:
    """Render and write; returns the frames' count, where they went and the
    render's seconds (the device synchronised)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerfstudio_torch.scripts.render {camera-path,interpolate,spiral,dataset} "
              "--load-config RUN_DIR [--camera-path-filename PATH.json] [--output-path renders/output.mp4] "
              "[--rendered-output-names rgb,depth] [--steps N] [--fps 24]")
        return {}
    mode = argv[0]
    args = dict(zip(argv[1::2], argv[2::2]))
    unknown = sorted(set(args) - set(FLAGS))
    if unknown or len(argv) % 2 == 0:
        raise SystemExit(f"unrecognized arguments: {unknown or argv[-1:]}")
    output_path = Path(args.get("--output-path", "renders/output.mp4"))
    out_names = tuple(args.get("--rendered-output-names", "rgb").split(","))

    from nerfstudio_torch.utils.eval_utils import eval_setup

    config, pipeline, state = eval_setup(Path(args["--load-config"]))
    cameras = path_cameras(mode, args, config, pipeline)
    device = config.machine.device()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames = render_frames(config, pipeline, state, cameras, out_names)
    seconds = time.perf_counter() - t0  # the frames are on the host: the device is done
    written = write_frames(frames, output_path, fps=int(args.get("--fps", "24")))
    return {"frames": len(frames), "output": str(written), "render_seconds": seconds}


if __name__ == "__main__":
    main()
