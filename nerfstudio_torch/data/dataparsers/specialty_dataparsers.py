"""The specialty dataset parsers: ScanNet, ScanNet++, ARKitScenes,
NuScenes, NeRF-OSR, DyCheck (iphone) and Sitcoms3D (counterpart of
``nerfstudio_tpu/data/dataparsers/specialty_dataparsers.py``).

Each reads its on-disk format on the host with numpy, in the reference's
order of operations, into DataparserOutputs with the cameras on the CPU.
NuScenes reads the dataset's relational JSON tables directly (no devkit);
DyCheck's cameras carry its frames' times; Sitcoms3D names each frame's
label image and the capture's classes (``semantics_filenames``,
``semantics_classes``), which ``SemanticDataset`` reads. A capture whose
images are JPEG (ScanNet's, NuScenes') needs Pillow to be read, which
``data/image_io`` asks for and raises without."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Literal, Optional

import numpy as np
import torch

from nerfstudio_torch.cameras import camera_utils
from nerfstudio_torch.cameras.cameras import CAMERA_MODEL_TO_TYPE, Cameras, CameraType
from nerfstudio_torch.data.dataparsers.base_dataparser import DataParser, DataParserConfig, DataparserOutputs
from nerfstudio_torch.data.scene_box import SceneBox


def _split_indices(n: int, train_fraction: float, split: str) -> np.ndarray:
    idx = np.arange(n)
    n_train = math.ceil(n * train_fraction)
    train = np.linspace(0, n - 1, n_train, dtype=np.int64)
    if split == "train":
        return train
    ev = np.setdiff1d(idx, train)
    return ev if ev.size else idx[-1:]


def _orient_scale(poses, orientation_method, center_method, auto_scale, scale_factor=1.0):
    poses, transform = camera_utils.auto_orient_and_center_poses(
        poses, method=orientation_method, center_method=center_method
    )
    poses = poses[:, :3]
    scale = 1.0
    if auto_scale:
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
    scale *= scale_factor
    poses[:, :3, 3] *= scale
    return poses, transform, scale


def _outputs(image_filenames, cameras, aabb_scale, transform, scale, depth_filenames=None,
             metadata=None, mask_filenames=None):
    scene_box = SceneBox(aabb=torch.tensor([[-aabb_scale] * 3, [aabb_scale] * 3], dtype=torch.float32))
    md = {"depth_filenames": depth_filenames, "depth_unit_scale_factor": 1e-3}
    if metadata:
        md.update(metadata)
    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=cameras,
        scene_box=scene_box,
        mask_filenames=mask_filenames,
        dataparser_transform=np.asarray(transform, np.float32)[:3],
        dataparser_scale=scale,
        metadata=md,
    )


# ---------------------------------------------------------------------------
# ScanNet: color/ depth/ pose/*.txt intrinsic/intrinsic_color.txt
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScanNetDataParserConfig(DataParserConfig):
    data: Path = Path("data/scannet/scene0423_02")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    train_split_fraction: float = 0.9
    load_3D_points: bool = False
    depth_unit_scale_factor: float = 1e-3

    def setup(self) -> "ScanNetDataParser":
        return ScanNetDataParser(config=self)


@dataclasses.dataclass
class ScanNetDataParser(DataParser):
    config: ScanNetDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        img_dir = data / "color"
        pose_dir = data / "pose"
        depth_dir = data / "depth"
        imgs = sorted(img_dir.iterdir(), key=lambda p: int(p.stem))
        K = np.loadtxt(data / "intrinsic" / "intrinsic_color.txt").reshape(4, 4)

        poses, image_filenames, depth_filenames = [], [], []
        for img in imgs:
            pose = np.loadtxt(pose_dir / f"{img.stem}.txt").reshape(4, 4)
            if not np.isfinite(pose).all():
                continue
            # OpenCV cam -> OpenGL cam
            pose[:3, 1] *= -1
            pose[:3, 2] *= -1
            poses.append(pose.astype(np.float32))
            image_filenames.append(img)
            d = depth_dir / f"{img.stem}.png"
            if d.exists():
                depth_filenames.append(d)

        poses = np.stack(poses)
        poses, transform, scale = _orient_scale(poses, "up", "poses", True, self.config.scale_factor)
        indices = _split_indices(len(image_filenames), self.config.train_split_fraction, split)

        cameras = Cameras.create(
            camera_to_worlds=poses[indices],
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            device="cpu",
        )
        return _outputs(
            [image_filenames[i] for i in indices], cameras, self.config.scene_scale,
            transform, scale,
            depth_filenames=[depth_filenames[i] for i in indices] if depth_filenames else None,
        )


# ---------------------------------------------------------------------------
# ScanNet++: dslr/nerfstudio/transforms.json with frames + test_frames
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScanNetppDataParserConfig(DataParserConfig):
    data: Path = Path("data/scannetpp/410c470782")
    transforms_path: Path = Path("dslr/nerfstudio/transforms.json")
    images_dir: Path = Path("dslr/resized_images")
    masks_dir: Path = Path("dslr/resized_anon_masks")
    scale_factor: float = 1.0
    scene_scale: float = 1.5

    def setup(self) -> "ScanNetppDataParser":
        return ScanNetppDataParser(config=self)


@dataclasses.dataclass
class ScanNetppDataParser(DataParser):
    config: ScanNetppDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        with open(data / self.config.transforms_path, encoding="utf-8") as f:
            meta = json.load(f)
        frames = meta["frames"] if split == "train" else meta.get("test_frames", meta["frames"])

        poses, image_filenames, mask_filenames = [], [], []
        for fr in frames:
            poses.append(np.asarray(fr["transform_matrix"], np.float32))
            image_filenames.append(data / self.config.images_dir / fr["file_path"])
            if fr.get("mask_path"):
                mask_filenames.append(data / self.config.masks_dir / fr["mask_path"])
        poses = np.stack(poses)
        poses, transform, scale = _orient_scale(poses, "up", "poses", True, self.config.scale_factor)

        distort = camera_utils.get_distortion_params(
            k1=float(meta.get("k1", 0)), k2=float(meta.get("k2", 0)),
            k3=float(meta.get("k3", 0)), k4=float(meta.get("k4", 0)),
            p1=float(meta.get("p1", 0)), p2=float(meta.get("p2", 0)),
        )
        n = len(poses)
        cam_type = CAMERA_MODEL_TO_TYPE.get(meta.get("camera_model", "OPENCV"), CameraType.PERSPECTIVE)
        cameras = Cameras.create(
            camera_to_worlds=poses,
            fx=float(meta["fl_x"]), fy=float(meta["fl_y"]),
            cx=float(meta["cx"]), cy=float(meta["cy"]),
            width=int(meta["w"]), height=int(meta["h"]),
            distortion_params=np.tile(distort, (n, 1)),
            camera_type=cam_type,
            device="cpu",
        )
        return _outputs(
            image_filenames, cameras, self.config.scene_scale, transform, scale,
            mask_filenames=mask_filenames or None,
        )


# ---------------------------------------------------------------------------
# ARKitScenes: {video}_frames/lowres_wide + .traj + .pincam intrinsics
# ---------------------------------------------------------------------------


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


@dataclasses.dataclass
class ARKitScenesDataParserConfig(DataParserConfig):
    data: Path = Path("data/arkitscenes/41069021")
    scale_factor: float = 1.0
    scene_scale: float = 1.0
    train_split_fraction: float = 0.9

    def setup(self) -> "ARKitScenesDataParser":
        return ARKitScenesDataParser(config=self)


@dataclasses.dataclass
class ARKitScenesDataParser(DataParser):
    config: ARKitScenesDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        video_id = data.name
        frames_dir = data / f"{video_id}_frames"
        img_dir = frames_dir / "lowres_wide"
        intr_dir = frames_dir / "lowres_wide_intrinsics"
        depth_dir = frames_dir / "lowres_depth"

        # trajectory: lines "ts rx ry rz tx ty tz" (world-from-camera inverse)
        traj = {}
        with open(frames_dir / "lowres_wide.traj", encoding="utf-8") as f:
            for line in f:
                v = [float(x) for x in line.split()]
                w2c = np.eye(4)
                w2c[:3, :3] = _rodrigues(np.asarray(v[1:4]))
                w2c[:3, 3] = v[4:7]
                traj[f"{round(v[0], 3):.3f}"] = np.linalg.inv(w2c)

        poses, image_filenames, depth_filenames = [], [], []
        fx, fy, cx, cy, ws, hs = [], [], [], [], [], []
        for img in sorted(img_dir.iterdir()):
            ts = img.stem.rsplit("_", 1)[1]
            key = f"{round(float(ts), 3):.3f}"
            pose = traj.get(key)
            if pose is None:
                for dt in (-0.001, 0.001):
                    pose = traj.get(f"{round(float(ts) + dt, 3):.3f}")
                    if pose is not None:
                        break
            if pose is None:
                continue
            pincam = intr_dir / f"{img.stem}.pincam"
            if not pincam.exists():
                continue
            w, h, fx_, fy_, cx_, cy_ = np.loadtxt(pincam)
            pose = pose.copy()
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose.astype(np.float32))
            image_filenames.append(img)
            fx.append(fx_), fy.append(fy_), cx.append(cx_), cy.append(cy_)
            ws.append(int(w)), hs.append(int(h))
            d = depth_dir / img.name
            if d.exists():
                depth_filenames.append(d)

        poses = np.stack(poses)
        poses, transform, scale = _orient_scale(poses, "up", "poses", True, self.config.scale_factor)
        indices = _split_indices(len(image_filenames), self.config.train_split_fraction, split)
        cameras = Cameras.create(
            camera_to_worlds=poses[indices],
            fx=np.asarray(fx, np.float32)[indices],
            fy=np.asarray(fy, np.float32)[indices],
            cx=np.asarray(cx, np.float32)[indices],
            cy=np.asarray(cy, np.float32)[indices],
            width=np.asarray(ws, np.int32)[indices],
            height=np.asarray(hs, np.int32)[indices],
            device="cpu",
        )
        return _outputs(
            [image_filenames[i] for i in indices], cameras, self.config.scene_scale,
            transform, scale,
            depth_filenames=[depth_filenames[i] for i in indices] if depth_filenames else None,
        )


# ---------------------------------------------------------------------------
# NuScenes: relational JSON tables (no devkit dependency)
# ---------------------------------------------------------------------------


def _quat_to_rot(q) -> np.ndarray:
    """Scalar-first (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = q
    n = math.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


@dataclasses.dataclass
class NuScenesDataParserConfig(DataParserConfig):
    data: Path = Path("scene-0103")  # scene name
    data_dir: Path = Path("data/nuscenes")
    version: Literal["v1.0-mini", "v1.0-trainval"] = "v1.0-mini"
    cameras: tuple = ("FRONT",)
    train_split_fraction: float = 0.9
    mask_dir: Optional[Path] = None

    def setup(self) -> "NuScenesDataParser":
        return NuScenesDataParser(config=self)


@dataclasses.dataclass
class NuScenesDataParser(DataParser):
    config: NuScenesDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        cfg = self.config
        root = Path(cfg.data_dir)
        tdir = root / cfg.version

        def table(name):
            with open(tdir / f"{name}.json", encoding="utf-8") as f:
                return json.load(f)

        scenes = {s["name"]: s for s in table("scene")}
        scene = scenes[str(cfg.data)]
        samples = {s["token"]: s for s in table("sample")}
        ego_poses = {p["token"]: p for p in table("ego_pose")}
        sensors = {c["token"]: c for c in table("calibrated_sensor")}

        wanted = {f"CAM_{c}" for c in cfg.cameras}
        sample_datas = [
            sd
            for sd in table("sample_data")
            if sd["is_key_frame"]
            and samples.get(sd["sample_token"], {}).get("scene_token") == scene["token"]
            and any(w in sd["filename"] for w in wanted)
        ]
        sample_datas.sort(key=lambda sd: (sd["filename"].split("/")[1], sd["timestamp"]))

        transform1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], float)

        poses, image_filenames, fx, fy, cx, cy = [], [], [], [], [], []
        for sd in sample_datas:
            calib = sensors[sd["calibrated_sensor_token"]]
            ego = ego_poses[sd["ego_pose_token"]]
            ego_pose = np.eye(4)
            ego_pose[:3, :3] = _quat_to_rot(ego["rotation"])
            ego_pose[:3, 3] = ego["translation"]
            cam_pose = np.eye(4)
            cam_pose[:3, :3] = _quat_to_rot(calib["rotation"])
            cam_pose[:3, 3] = calib["translation"]
            pose = transform1 @ (ego_pose @ cam_pose)
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose[:4].astype(np.float32))
            image_filenames.append(root / sd["filename"])
            K = np.asarray(calib["camera_intrinsic"], float)
            fx.append(K[0, 0]), fy.append(K[1, 1]), cx.append(K[0, 2]), cy.append(K[1, 2])

        poses = np.stack(poses)
        # center + scale (nuscenes scenes are large; normalize translations)
        poses[:, :3, 3] -= poses[:, :3, 3].mean(axis=0)
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-8)
        poses[:, :3, 3] *= scale
        transform = np.eye(4)[:3]

        indices = _split_indices(len(image_filenames), cfg.train_split_fraction, split)
        cameras = Cameras.create(
            camera_to_worlds=poses[indices, :3],
            fx=np.asarray(fx, np.float32)[indices],
            fy=np.asarray(fy, np.float32)[indices],
            cx=np.asarray(cx, np.float32)[indices],
            cy=np.asarray(cy, np.float32)[indices],
            width=1600,
            height=900,
            device="cpu",
        )
        return _outputs([image_filenames[i] for i in indices], cameras, 1.0, transform, scale)


# ---------------------------------------------------------------------------
# NeRF-OSR: {scene}/final/{split}/{rgb,pose,intrinsics}
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NeRFOSRDataParserConfig(DataParserConfig):
    data: Path = Path("data/nerfosr")
    scene: str = "stjacob"
    scene_scale: float = 1.0
    use_masks: bool = False

    def setup(self) -> "NeRFOSRDataParser":
        return NeRFOSRDataParser(config=self)


@dataclasses.dataclass
class NeRFOSRDataParser(DataParser):
    config: NeRFOSRDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        scene = self.config.scene
        split = {"train": "train", "val": "val", "test": "test"}.get(split, "val")
        base = data / scene / "final" / split
        if not base.exists():
            base = data / scene / split
        if not base.exists():
            raise FileNotFoundError(base)

        rgb_dir = base / "rgb"
        image_filenames = sorted(
            p for p in rgb_dir.iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg")
        )
        poses, intr = [], []
        for img in image_filenames:
            pose = np.array((base / "pose" / f"{img.stem}.txt").read_text().split(), dtype=float).reshape(4, 4)
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose.astype(np.float32))
            K = np.array((base / "intrinsics" / f"{img.stem}.txt").read_text().split(), dtype=float).reshape(4, 4)
            intr.append(K)
        poses = np.stack(poses)
        poses, transform, scale = _orient_scale(poses, "up", "poses", True, 1.0)
        intr = np.stack(intr)
        cameras = Cameras.create(
            camera_to_worlds=poses,
            fx=intr[:, 0, 0].astype(np.float32),
            fy=intr[:, 1, 1].astype(np.float32),
            cx=intr[:, 0, 2].astype(np.float32),
            cy=intr[:, 1, 2].astype(np.float32),
            device="cpu",
        )
        masks = None
        if self.config.use_masks:
            mdir = base / "mask"
            if mdir.exists():
                masks = [mdir / img.name for img in image_filenames]
        return _outputs(image_filenames, cameras, self.config.scene_scale, transform, scale,
                        mask_filenames=masks)


# ---------------------------------------------------------------------------
# DyCheck (iphone subset): scene/dataset/metadata jsons + per-frame cameras
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DycheckDataParserConfig(DataParserConfig):
    data: Path = Path("data/iphone/mochi-high-five")
    downscale_factor: int = 2
    scene_box_bound: float = 1.5

    def setup(self) -> "DycheckDataParser":
        return DycheckDataParser(config=self)


@dataclasses.dataclass
class DycheckDataParser(DataParser):
    config: DycheckDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        d = self.config.downscale_factor
        with open(data / "scene.json", encoding="utf-8") as f:
            scene = json.load(f)
        with open(data / "metadata.json", encoding="utf-8") as f:
            metadata = json.load(f)
        split_file = data / "splits" / f"{split}.json"
        if not split_file.exists():
            split_file = data / "splits" / "train.json"
        with open(split_file, encoding="utf-8") as f:
            split_dict = json.load(f)
        frame_names = split_dict["frame_names"]
        time_ids = np.asarray(split_dict["time_ids"], np.float32)

        center = np.asarray(scene.get("center", [0, 0, 0]), float)
        scene_scale = float(scene.get("scale", 1.0))

        poses, image_filenames, depth_filenames = [], [], []
        fx, fy, cx, cy, ws, hs = [], [], [], [], [], []
        for frame in frame_names:
            with open(data / "camera" / f"{frame}.json", encoding="utf-8") as f:
                cam = json.load(f)
            R = np.asarray(cam["orientation"], float)  # world-to-camera rotation
            pos = (np.asarray(cam["position"], float) - center) * scene_scale
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = pos
            c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(c2w[:3].astype(np.float32))
            image_filenames.append(data / "rgb" / f"{d}x" / f"{frame}.png")
            dp = data / "processed_depth" / f"{d}x" / f"{frame}.npy"
            if dp.exists():
                depth_filenames.append(dp)
            fx.append(cam["focal_length"] / d)
            fy.append(cam["focal_length"] * cam.get("pixel_aspect_ratio", 1.0) / d)
            cx.append(cam["principal_point"][0] / d)
            cy.append(cam["principal_point"][1] / d)
            ws.append(int(cam["image_size"][0]) // d)
            hs.append(int(cam["image_size"][1]) // d)

        poses = np.stack(poses)
        times = time_ids / max(float(metadata.get("num_frames", time_ids.max() + 1)), 1.0)
        cameras = Cameras.create(
            camera_to_worlds=poses,
            fx=np.asarray(fx, np.float32),
            fy=np.asarray(fy, np.float32),
            cx=np.asarray(cx, np.float32),
            cy=np.asarray(cy, np.float32),
            width=np.asarray(ws, np.int32),
            height=np.asarray(hs, np.int32),
            times=times[:, None],
            device="cpu",
        )
        return _outputs(
            image_filenames, cameras, self.config.scene_box_bound,
            np.eye(4)[:3], scene_scale,
            depth_filenames=depth_filenames or None,
            metadata={"depth_unit_scale_factor": 1.0},
        )


# ---------------------------------------------------------------------------
# Sitcoms3D: cameras.json with per-frame intrinsics + camtoworlds
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Sitcoms3DDataParserConfig(DataParserConfig):
    data: Path = Path("data/sitcoms3d/TBBT-big_living_room")
    include_semantics: bool = True
    downscale_factor: int = 4
    scene_scale: float = 2.0

    def setup(self) -> "Sitcoms3DDataParser":
        return Sitcoms3DDataParser(config=self)


@dataclasses.dataclass
class Sitcoms3DDataParser(DataParser):
    config: Sitcoms3DDataParserConfig

    def _generate_dataparser_outputs(self, split: str = "train", **kwargs) -> DataparserOutputs:
        data = Path(self.config.data)
        d = self.config.downscale_factor
        with open(data / "cameras.json", encoding="utf-8") as f:
            cameras_json = json.load(f)
        frames = cameras_json["frames"]
        bbox = np.asarray(cameras_json["bbox"], np.float32)

        img_dir = f"images_{d}" if d > 1 else "images"
        poses, image_filenames, fx, fy, cx, cy = [], [], [], [], [], []
        for fr in frames:
            K = np.asarray(fr["intrinsics"], float)
            pose = np.asarray(fr["camtoworld"], np.float32)
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose)
            image_filenames.append(data / img_dir / fr["image_name"])
            fx.append(K[0, 0] / d), fy.append(K[1, 1] / d)
            cx.append(K[0, 2] / d), cy.append(K[1, 2] / d)
        poses = np.stack(poses)

        # normalize by the bbox (reference centers on the bbox + scales)
        center = bbox.mean(axis=0)
        scale = 1.0 / max(float(np.max(bbox[1] - bbox[0]) / 2.0), 1e-8)
        poses[:, :3, 3] = (poses[:, :3, 3] - center) * scale
        transform = np.eye(4)
        transform[:3, 3] = -center
        transform[:3] *= scale

        semantics = None
        if self.config.include_semantics:
            cls_path = data / "panoptic_classes.json"
            if cls_path.exists():
                with open(cls_path, encoding="utf-8") as f:
                    classes = json.load(f)["thing"]
                sem_dir = data / f"segmentations_{d}" / "thing"
                semantics = {
                    "semantics_filenames": [sem_dir / Path(p).name for p in
                                            (fr["image_name"] for fr in frames)],
                    "semantics_classes": classes,
                }

        cameras = Cameras.create(
            camera_to_worlds=poses[:, :3],
            fx=np.asarray(fx, np.float32),
            fy=np.asarray(fy, np.float32),
            cx=np.asarray(cx, np.float32),
            cy=np.asarray(cy, np.float32),
            device="cpu",
        )
        return _outputs(
            image_filenames, cameras, self.config.scene_scale, transform[:3], scale,
            metadata=semantics,
        )


SPECIALTY_PARSERS = {
    "scannet-data": ScanNetDataParserConfig,
    "scannetpp-data": ScanNetppDataParserConfig,
    "arkitscenes-data": ARKitScenesDataParserConfig,
    "nuscenes-data": NuScenesDataParserConfig,
    "nerfosr-data": NeRFOSRDataParserConfig,
    "dycheck-data": DycheckDataParserConfig,
    "sitcoms3d-data": Sitcoms3DDataParserConfig,
}
