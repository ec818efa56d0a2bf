"""Export a trained run as a point cloud, mesh, 3DGS splat or camera list
(counterpart of ``nerfstudio_tpu/scripts/exporter.py``):

    python -m nerfstudio_torch.scripts.exporter {pointcloud,gaussian-splat,cameras,marching-cubes,tsdf,poisson,
        texture-mesh} --load-config RUN_DIR [--output-dir exports] [--num-points N] [--resolution R] [--num-views V]

Every mode loads the run (``utils.eval_utils.eval_setup``) on the device
its config names. ``pointcloud``, ``tsdf`` and ``poisson`` render the train
views through ``pipeline.render_camera``; ``marching-cubes`` and
``texture-mesh`` evaluate the field's density on a grid (the model in eval
mode: nerfacto's K3) and ``texture-mesh`` bakes the radiance at the mesh's
texels in chunks of the model's ``eval_num_rays_per_chunk`` rays;
``gaussian-splat`` writes splatfacto's live gaussians in the standard 3DGS
PLY layout (x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*), in slot
order."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

FLAGS = ("--load-config", "--output-dir", "--num-points", "--resolution", "--num-views")


def xyz_fields(verts: np.ndarray) -> dict:
    return {c: verts[:, i].astype(np.float32) for i, c in enumerate("xyz")}


def export_pointcloud(run_dir: Path, output_dir: Path, num_points: int = 1000000) -> None:
    """(reference :17-35)"""
    from nerfstudio_torch.exporter.exporter_utils import generate_point_cloud
    from nerfstudio_torch.exporter.ply_io import write_ply
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, state = eval_setup(run_dir)
    points, colors = generate_point_cloud(pipeline, state, num_points=num_points)
    n = len(points)
    fields = xyz_fields(points)
    for i, c in enumerate(("red", "green", "blue")):
        fields[c] = (colors[:, i] * 255).astype(np.uint8)
    write_ply(output_dir / "point_cloud.ply", n, fields)
    print(f"exported {n} points to {output_dir / 'point_cloud.ply'}", flush=True)


def export_gaussian_splat(run_dir: Path, output_dir: Path) -> None:
    """(reference :38-44)"""
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, _, state = eval_setup(run_dir)
    write_splat_ply(state.params, state.aux.alive, output_dir / "splat.ply")


def write_splat_ply(params, alive, out_path: Path) -> None:
    """The live slots of the padded gaussian tensors, in slot order, in the
    3DGS PLY layout (reference :47-74)."""
    from nerfstudio_torch.exporter.ply_io import write_ply

    alive = np.asarray(torch.as_tensor(alive).cpu())

    def live(name):
        return torch.as_tensor(params[name]).detach().cpu().numpy()[alive]

    means, scales, quats = live("means"), live("scales"), live("quats")
    f_dc, f_rest, opac = live("features_dc"), live("features_rest"), live("opacities")
    n = len(means)
    fields = xyz_fields(means)
    fields.update({k: np.zeros(n, np.float32) for k in ("nx", "ny", "nz")})
    for i in range(3):
        fields[f"f_dc_{i}"] = f_dc[:, i].astype(np.float32)
    rest = f_rest.transpose(0, 2, 1).reshape(n, -1)  # (n, 3*(K-1)) channel-major
    for i in range(rest.shape[1]):
        fields[f"f_rest_{i}"] = rest[:, i].astype(np.float32)
    fields["opacity"] = opac[:, 0].astype(np.float32)
    for i in range(3):
        fields[f"scale_{i}"] = scales[:, i].astype(np.float32)
    for i in range(4):
        fields[f"rot_{i}"] = quats[:, i].astype(np.float32)
    write_ply(Path(out_path), n, fields)
    print(f"exported {n} gaussians to {out_path}", flush=True)


def export_cameras(run_dir: Path, output_dir: Path) -> None:
    """The train cameras as the viewer's JSON (reference :77-88)."""
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, _ = eval_setup(run_dir)
    cams = pipeline.datamanager.train_cameras
    out = [cams.to_json(i) for i in range(len(cams))]
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "cameras.json").write_text(json.dumps(out, indent=2), "utf8")
    print(f"exported {len(out)} cameras", flush=True)


def density_mesh(pipeline, resolution: int):
    """Marching cubes of the eval model's density over [-1, 1]^3 at level
    max(mean, 1) (reference :91-101, :179-188): (verts, faces)."""
    from nerfstudio_torch.exporter.marching_cubes import evaluate_grid, marching_cubes

    model = pipeline.model.eval()
    vol = evaluate_grid(model.field.density_fn, resolution=resolution, device=pipeline.device)
    return marching_cubes(vol, level=max(float(vol.mean()), 1.0))


def export_marching_cubes(run_dir: Path, output_dir: Path, resolution: int = 256) -> None:
    """The surface's vertices (reference :91-113)."""
    from nerfstudio_torch.exporter.ply_io import write_ply
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, _ = eval_setup(run_dir)
    verts, _ = density_mesh(pipeline, resolution)
    write_ply(output_dir / "mesh_points.ply", len(verts), xyz_fields(verts))
    print(f"exported {len(verts)} surface vertices", flush=True)


def export_tsdf(run_dir: Path, output_dir: Path, resolution: int = 128, num_views: int = 40) -> None:
    """TSDF fusion of rendered train-view depths -> coloured mesh vertices
    and faces (reference :116-139)."""
    from nerfstudio_torch.exporter.tsdf_utils import export_tsdf_mesh
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, state = eval_setup(run_dir)
    verts, faces, colors = export_tsdf_mesh(pipeline, state, output_dir, resolution=resolution, num_views=num_views)
    write_tsdf_mesh(output_dir, verts, faces, colors)
    print(f"exported TSDF mesh: {len(verts)} vertices", flush=True)


def write_tsdf_mesh(output_dir: Path, verts: np.ndarray, faces, colors) -> None:
    """``tsdf_mesh.ply`` (vertices, coloured where ``colors``) and
    ``tsdf_faces.npy`` in ``output_dir``."""
    from nerfstudio_torch.exporter.ply_io import write_ply

    fields = xyz_fields(verts)
    if colors is not None:
        for i, c in enumerate(("red", "green", "blue")):
            fields[c] = np.clip(colors[:, i] * 255, 0, 255).astype(np.uint8)
    write_ply(output_dir / "tsdf_mesh.ply", len(verts), fields)
    if faces is not None:
        np.save(output_dir / "tsdf_faces.npy", faces)


def export_poisson(run_dir: Path, output_dir: Path, num_points: int = 500000, resolution: int = 128) -> None:
    """Poisson reconstruction from a rendered point cloud with normals
    (reference :142-167)."""
    from nerfstudio_torch.exporter.exporter_utils import generate_point_cloud
    from nerfstudio_torch.exporter.ply_io import write_ply
    from nerfstudio_torch.exporter.poisson import export_poisson_mesh
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, state = eval_setup(run_dir)
    pts, _, normals = generate_point_cloud(pipeline, state, num_points=num_points, return_normals=True)
    verts, faces = export_poisson_mesh(pts, normals, resolution=resolution, device=pipeline.device)
    write_ply(output_dir / "poisson_mesh.ply", len(verts), xyz_fields(verts))
    if faces is not None:
        np.save(output_dir / "poisson_faces.npy", faces)
    print(f"exported poisson mesh: {len(verts)} vertices", flush=True)


def texel_query(pipeline, state):
    """The bake's ``query_rgb``: the eval model's colour of rays from each
    point along -z over [0, 1e-3] (nears and fars given, so no collider
    runs), in chunks of ``eval_num_rays_per_chunk`` rays; the reference
    runs every texel in one call (reference :179-193)."""
    from nerfstudio_torch.core.rays import RayBundle

    model, device = pipeline.model.eval(), pipeline.device
    chunk = model.config.eval_num_rays_per_chunk
    kwargs = {} if state.aux is None else {"model_aux": state.aux}

    def query_rgb(points: np.ndarray) -> np.ndarray:
        out = np.empty((len(points), 3), np.float32)
        for s in range(0, len(points), chunk):
            p = torch.from_numpy(np.asarray(points[s : s + chunk], np.float32)).to(device)
            m = p.shape[0]
            rb = RayBundle(origins=p, directions=torch.tensor([0.0, 0.0, -1.0], device=device).expand(m, 3),
                           pixel_area=torch.ones((m, 1), device=device) * 1e-6,
                           nears=torch.zeros((m, 1), device=device), fars=torch.full((m, 1), 1e-3, device=device))
            with torch.no_grad():
                out[s : s + m] = model(rb, **kwargs)["rgb"].float().cpu().numpy()
        return out

    return query_rgb


def export_texture_mesh(run_dir: Path, output_dir: Path, resolution: int = 128) -> None:
    """Marching-cubes mesh with a baked texture: OBJ, MTL, PNG (reference
    :170-196)."""
    from nerfstudio_torch.exporter.texture_utils import export_textured_mesh
    from nerfstudio_torch.utils.eval_utils import eval_setup

    _, pipeline, state = eval_setup(run_dir)
    verts, faces = density_mesh(pipeline, resolution)
    export_textured_mesh(verts, faces, texel_query(pipeline, state), output_dir, name="textured_mesh")
    print(f"exported textured mesh: {len(verts)} verts, {len(faces)} faces", flush=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerfstudio_torch.scripts.exporter {pointcloud,gaussian-splat,cameras,"
              "marching-cubes,tsdf,poisson,texture-mesh} --load-config RUN_DIR [--output-dir DIR] "
              "[--num-points N] [--resolution R] [--num-views V]")
        return
    mode = argv[0]
    args = dict(zip(argv[1::2], argv[2::2]))
    unknown = sorted(set(args) - set(FLAGS))
    if unknown or len(argv) % 2 == 0:
        raise SystemExit(f"unrecognized arguments: {unknown or argv[-1:]}")
    run_dir = Path(args["--load-config"])
    output_dir = Path(args.get("--output-dir", "exports"))
    output_dir.mkdir(parents=True, exist_ok=True)
    if mode == "pointcloud":
        export_pointcloud(run_dir, output_dir, int(args.get("--num-points", "1000000")))
    elif mode == "gaussian-splat":
        export_gaussian_splat(run_dir, output_dir)
    elif mode == "cameras":
        export_cameras(run_dir, output_dir)
    elif mode == "marching-cubes":
        export_marching_cubes(run_dir, output_dir, int(args.get("--resolution", "256")))
    elif mode == "tsdf":
        export_tsdf(run_dir, output_dir, int(args.get("--resolution", "128")), int(args.get("--num-views", "40")))
    elif mode == "poisson":
        export_poisson(run_dir, output_dir, int(args.get("--num-points", "500000")),
                       int(args.get("--resolution", "128")))
    elif mode == "texture-mesh":
        export_texture_mesh(run_dir, output_dir, int(args.get("--resolution", "128")))
    else:
        raise SystemExit(f"unknown export mode {mode}")


if __name__ == "__main__":
    main()
