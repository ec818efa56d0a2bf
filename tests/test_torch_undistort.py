"""The port's whole-image undistortion against the JAX package's: uint8 and
float32 images bit-equal for the OpenCV radial-tangential and the fisheye
models; all-zero distortion leaves a stack and its cameras as they are;
``FullImageDatamanager`` on the synthetic tool's ``distorted`` scene
uploads the same undistorted train images as JAX's and zeroes its train
cameras' distortion; the splat eval holds its render to the same
undistorted ground truth as JAX's."""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import CPU
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.data import undistort as jun
from nerfstudio_tpu.data.datamanagers import DataManagerConfig as JDMConfig
from nerfstudio_tpu.data.datamanagers import FullImageDatamanager as JFullImage
from nerfstudio_tpu.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig as JNerfstudio
from nerfstudio_tpu.data.datasets import InputDataset as JInputDataset
from nerfstudio_torch.cameras.cameras import Cameras, CameraType
from nerfstudio_torch.data import undistort as tun
from nerfstudio_torch.data.datamanagers import DataManagerConfig, FullImageDatamanager
from nerfstudio_torch.data.dataparsers.nerfstudio_dataparser import NerfstudioDataParserConfig
from nerfstudio_torch.data.datasets import InputDataset
from nerfstudio_torch.pipelines import splat_pipeline

REPO = Path(__file__).resolve().parent.parent
MODELS = {"opencv": (CameraType.PERSPECTIVE, np.array([-0.18, 0.04, 0.01, -0.003, 2e-3, -1e-3], np.float32)),
          "fisheye": (CameraType.FISHEYE, np.array([0.08, -0.02, 0.004, -5e-4, 0.0, 0.0], np.float32))}


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("model", list(MODELS))
def test_undistort_image_is_bit_equal(model, dtype):
    ctype, d = MODELS[model]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)
    if dtype is np.float32:
        img = img.astype(np.float32) / 255.0
    args = (np.float32(22.0), np.float32(23.5), np.float32(14.2), np.float32(9.7), d, ctype.value)
    out = tun.undistort_image(img, *args)
    ref = jun.undistort_image(img, *args)
    assert out.dtype == ref.dtype == img.dtype
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, img)


def _cams(d, n=3):
    c2w = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    return Cameras.create(c2w, 22.0, 23.0, 14.0, 10.0, 28, 20, distortion_params=d, device=CPU)


def test_zero_distortion_is_the_identity():
    """No distortion or all-zero rows: the same stack and cameras back, as
    the reference returns them; non-zero rows: JAX's images and zeroed
    distortion."""
    images = np.random.default_rng(1).integers(0, 256, (3, 20, 28, 3)).astype(np.uint8)
    for d in (None, np.zeros(6, np.float32)):
        cams = _cams(d)
        out, out_cams = tun.maybe_undistort_dataset(images, cams)
        assert out is images and out_cams is cams
    d = np.stack([MODELS["opencv"][1], np.zeros(6, np.float32), MODELS["opencv"][1] * 0.5])
    out, out_cams = tun.maybe_undistort_dataset(images, _cams(d))
    jcams = JCameras(camera_to_worlds=np.tile(np.eye(4, dtype=np.float32)[:3], (3, 1, 1)), fx=22.0, fy=23.0, cx=14.0,
                     cy=10.0, width=28, height=20, distortion_params=d)
    ref, ref_cams = jun.maybe_undistort_dataset(images, jcams)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[1], images[1])
    assert torch.equal(out_cams.distortion_params, torch.zeros(3, 6)) and out_cams.distorted is False
    np.testing.assert_array_equal(out_cams.distortion_params.numpy(), np.asarray(ref_cams.distortion_params))


@pytest.fixture(scope="module")
def distorted(tmp_path_factory):
    root = tmp_path_factory.mktemp("distorted") / "scene"
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"), str(root), "--scene",
                    "distorted", "--hw", "24", "--n-train", "4", "--n-test", "2", "--n-points", "100"],
                   check=True, capture_output=True, timeout=300)
    kw = dict(data=root, train_split_fraction=0.5, downscale_factor=1)
    j = {s: JInputDataset(JNerfstudio(**kw).setup().get_dataparser_outputs(s)) for s in ("train", "val")}
    t = {s: InputDataset(NerfstudioDataParserConfig(**kw).setup().get_dataparser_outputs(s)) for s in ("train", "val")}
    return j, t


def test_full_image_datamanager_zeroes_the_distortion(distorted):
    j, t = distorted
    jdm = JFullImage(JDMConfig(), j["train"], j["val"])
    tdm = FullImageDatamanager.from_datasets(DataManagerConfig(), t["train"], t["val"], device=CPU)
    np.testing.assert_array_equal(tdm.train_images.numpy(), np.asarray(jdm.train_images))
    assert not np.array_equal(tdm.train_images.numpy(), t["train"].load_all()["images"])
    assert torch.equal(tdm.train_cameras.distortion_params, torch.zeros(len(t["train"]), 6))
    np.testing.assert_array_equal(np.asarray(jdm.train_cameras.distortion_params), 0.0)
    # the eval cameras keep their distortion: the eval undistorts per view
    assert tdm.eval_cameras.distorted
    assert float(tdm.eval_cameras.distortion_params[0, 0]) == pytest.approx(-0.18)


def test_splat_eval_ground_truth_is_undistorted(distorted, monkeypatch):
    """The ground truth the port's splat eval scores against is JAX's
    (splat_pipeline.py:687-705: the float32 image undistorted under the
    eval camera), bit for bit."""
    j, t = distorted
    tdm = FullImageDatamanager.from_datasets(DataManagerConfig(), t["train"], t["val"], device=CPU)
    seen = []
    monkeypatch.setattr(splat_pipeline, "psnr", lambda pred, gt: seen.append(gt) or torch.tensor(0.0))
    monkeypatch.setattr(splat_pipeline, "ssim", lambda pred, gt: torch.tensor(0.0))
    jcams = j["val"].cameras
    for i in range(len(t["val"])):
        out = {"rgb": torch.zeros(24, 24, 3), "background": torch.zeros(3)}
        splat_pipeline.SplatPipeline._image_metrics(types.SimpleNamespace(datamanager=tdm), out, i)
        ref = jun.undistort_image(j["val"].get_image_float32(i), float(np.asarray(jcams.fx)[i, 0]),
                                  float(np.asarray(jcams.fy)[i, 0]), float(np.asarray(jcams.cx)[i, 0]),
                                  float(np.asarray(jcams.cy)[i, 0]), np.asarray(jcams.distortion_params)[i],
                                  int(np.asarray(jcams.camera_type).reshape(-1)[i]))
        np.testing.assert_array_equal(seen[-1].numpy(), ref)
        assert not np.array_equal(ref, j["val"].get_image_float32(i))
