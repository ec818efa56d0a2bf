"""Capture ingestion (counterpart of ``nerfstudio_tpu/scripts/process_data.py``;
reference nerfstudio/scripts/process_data.py):

    python -m nerfstudio_torch.scripts.process_data SUBCOMMAND --data PATH --output-dir DIR [...]

Subcommands, with the JAX script's flags:
    images          images dir -> pyramids -> COLMAP SfM -> transforms.json (needs colmap)
    video           video -> frames (ffmpeg) -> COLMAP -> transforms.json
    colmap          existing COLMAP model -> transforms.json (no binaries)
    polycam | record3d | metashape | realitycapture | odm
                    vendor captures -> transforms.json (pure parsing)

Everything runs on the host. PNG captures need no Pillow; JPEG, TIFF and
BMP go through Pillow where it imports."""

from __future__ import annotations

import argparse
from pathlib import Path


def process_images(data: Path, output_dir: Path, num_downscales: int, camera_model: str,
                   matching_method: str, camera_type: str = "perspective",
                   images_per_equirect: int = 8, sfm_tool: str = "colmap") -> None:
    from nerfstudio_torch.process_data.colmap_utils import colmap_to_json, run_colmap
    from nerfstudio_torch.process_data.process_data_utils import copy_images

    if camera_type == "fisheye":
        camera_model = "OPENCV_FISHEYE"
    if camera_type == "equirectangular":
        # 360 panoramas: crop pinhole views first, then SfM the crops
        # (reference process_data/images_to_nerfstudio_dataset.py equirect path).
        from nerfstudio_torch.process_data.equirect_utils import (
            compute_resolution_from_equirect,
            generate_planar_projections_from_equirectangular,
        )

        size = compute_resolution_from_equirect(data, images_per_equirect)
        data = generate_planar_projections_from_equirectangular(data, size, images_per_equirect)
        print(f"equirect -> {images_per_equirect} pinhole views/pano at {size} in {data}")

    output_dir.mkdir(parents=True, exist_ok=True)
    copied = copy_images(data, output_dir, num_downscales=num_downscales)
    print(f"copied {len(copied)} images")
    colmap_dir = output_dir / "colmap"
    if sfm_tool == "hloc":
        from nerfstudio_torch.process_data.hloc_utils import run_hloc

        run_hloc(output_dir / "images", colmap_dir, camera_model, matching_method)
    else:
        run_colmap(output_dir / "images", colmap_dir, camera_model, matching_method)
    n = colmap_to_json(colmap_dir / "sparse" / "0", output_dir)
    print(f"registered {n}/{len(copied)} frames -> {output_dir/'transforms.json'}")


def process_video(data: Path, output_dir: Path, num_frames: int, num_downscales: int,
                  camera_model: str, matching_method: str) -> None:
    import tempfile

    from nerfstudio_torch.process_data.process_data_utils import convert_video_to_images

    with tempfile.TemporaryDirectory() as td:
        frames = convert_video_to_images(data, Path(td), num_frames)
        print(f"extracted {len(frames)} frames")
        process_images(Path(td), output_dir, num_downscales, camera_model, matching_method)


def entrypoint(argv=None) -> None:
    ap = argparse.ArgumentParser("python -m nerfstudio_torch.scripts.process_data", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--data", type=Path, required=True)
        p.add_argument("--output-dir", type=Path, required=True)

    p = sub.add_parser("images")
    common(p)
    p.add_argument("--num-downscales", type=int, default=3)
    p.add_argument("--camera-model", default="OPENCV")
    p.add_argument("--matching-method", default="exhaustive")
    p.add_argument("--camera-type", default="perspective",
                   choices=("perspective", "fisheye", "equirectangular"))
    p.add_argument("--images-per-equirect", type=int, default=8)
    p.add_argument("--sfm-tool", default="colmap", choices=("colmap", "hloc"))

    p = sub.add_parser("video")
    common(p)
    p.add_argument("--num-frames-target", type=int, default=300)
    p.add_argument("--num-downscales", type=int, default=3)
    p.add_argument("--camera-model", default="OPENCV")
    p.add_argument("--matching-method", default="sequential")

    p = sub.add_parser("colmap")
    common(p)

    for name in ("polycam", "record3d", "metashape", "realitycapture", "odm"):
        p = sub.add_parser(name)
        common(p)
        if name in ("metashape", "realitycapture", "odm"):
            p.add_argument("--image-dir", default="images")

    args = ap.parse_args(argv)
    out = args.output_dir

    if args.cmd == "images":
        process_images(args.data, out, args.num_downscales, args.camera_model,
                       args.matching_method, camera_type=args.camera_type,
                       images_per_equirect=args.images_per_equirect,
                       sfm_tool=args.sfm_tool)
    elif args.cmd == "video":
        process_video(args.data, out, args.num_frames_target, args.num_downscales,
                      args.camera_model, args.matching_method)
    elif args.cmd == "colmap":
        from nerfstudio_torch.process_data.colmap_utils import colmap_to_json

        n = colmap_to_json(args.data, out)
        print(f"converted {n} frames -> {out/'transforms.json'}")
    elif args.cmd == "polycam":
        from nerfstudio_torch.process_data.converters import polycam_to_json

        n = polycam_to_json(args.data, out)
        print(f"converted {n} polycam frames")
    elif args.cmd == "record3d":
        from nerfstudio_torch.process_data.converters import record3d_to_json

        n = record3d_to_json(args.data, out)
        print(f"converted {n} record3d frames")
    elif args.cmd == "metashape":
        from nerfstudio_torch.process_data.converters import metashape_to_json

        n = metashape_to_json(args.data, args.image_dir, out)
        print(f"converted {n} metashape frames")
    elif args.cmd == "realitycapture":
        from nerfstudio_torch.process_data.converters import realitycapture_to_json

        n = realitycapture_to_json(args.data, args.image_dir, out)
        print(f"converted {n} realitycapture frames")
    elif args.cmd == "odm":
        from nerfstudio_torch.process_data.converters import odm_to_json

        n = odm_to_json(args.data, args.image_dir, out)
        print(f"converted {n} odm frames")


if __name__ == "__main__":
    entrypoint()
