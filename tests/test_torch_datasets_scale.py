"""``InputDataset(scale_factor=s)`` in the port against Pillow and the JAX
package's: each image resized to (int(w s), int(h s)) equal on every pixel
to Pillow's ``Image.BILINEAR`` resize (and to JAX's dataset, which calls
it) at s = 0.5, 0.25, 0.3 and 1.5, for RGB, RGBA (resized premultiplied,
as Pillow does) and grey PNGs, the float images and the stacked split too;
the rescaled cameras equal to JAX's on the same parser outputs."""

import numpy as np
import pytest
from PIL import Image

from _torch_port import orbit_c2w
from nerfstudio_tpu.cameras.cameras import Cameras as JCameras
from nerfstudio_tpu.data.dataparsers.base_dataparser import DataparserOutputs as JDataparserOutputs
from nerfstudio_tpu.data.datasets import InputDataset as JInputDataset
from nerfstudio_torch.data.datasets import InputDataset
from nerfstudio_torch.process_data.process_data_utils import resize_bilinear
from nerfstudio_torch.utils.convert import dataparser_outputs_from_jax

SCALES = (0.5, 0.25, 0.3, 1.5)
MODES = {"RGB": 3, "RGBA": 4, "L": 1}
H, W, N = 37, 53, 3


def _image(rng, c):
    """A smooth gradient plus noise; an alpha channel of 0, 255 and values between."""
    y, x = np.mgrid[0:H, 0:W]
    img = ((x * 5 + y * 3)[..., None] + np.arange(c) * 60 + rng.integers(0, 20, (H, W, c))) % 256
    if c == 4:
        img[..., 3] = rng.choice([0, 1, 77, 128, 254, 255], (H, W))
    return img.astype(np.uint8)


def _outputs(root, mode):
    """JAX's parser outputs over N PNGs of ``mode``, and the port's."""
    rng = np.random.default_rng(len(mode))
    files = []
    for i in range(N):
        img = _image(rng, MODES[mode])
        path = root / f"frame_{i}.png"
        Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
        files.append(path)
    cams = JCameras(camera_to_worlds=orbit_c2w(N), fx=np.full((N, 1), 41.3, np.float32),
                    fy=np.full((N, 1), 40.7, np.float32), cx=np.full((N, 1), W / 2, np.float32),
                    cy=np.full((N, 1), H / 2, np.float32), width=np.full((N, 1), W), height=np.full((N, 1), H))
    jout = JDataparserOutputs(image_filenames=files, cameras=cams)
    return jout, dataparser_outputs_from_jax(jout)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("mode", list(MODES))
def test_images_equal_pillow_bilinear(tmp_path, mode, scale):
    """Every image byte-equal to Pillow's BILINEAR resize of the file and to
    JAX's dataset's (grey repeated to three channels by both); the float
    images (alpha multiplied in) and the stacked split equal JAX's."""
    jout, tout = _outputs(tmp_path, mode)
    jds, tds = JInputDataset(jout, scale_factor=scale), InputDataset(tout, scale_factor=scale)
    size = (int(W * scale), int(H * scale))
    for i in range(N):
        pil = np.asarray(Image.open(jout.image_filenames[i]).resize(size, Image.BILINEAR))
        pil = np.repeat(pil[..., None], 3, axis=-1) if pil.ndim == 2 else pil
        got = tds.get_numpy_image(i)
        assert got.shape == (size[1], size[0], max(MODES[mode], 3))
        assert np.array_equal(got, pil) and np.array_equal(got, jds.get_numpy_image(i)), i
        assert np.array_equal(tds.get_image_float32(i), jds.get_image_float32(i))
    assert np.array_equal(tds.load_all()["images"], jds.load_all()["images"])


@pytest.mark.parametrize("scale", SCALES)
def test_cameras_rescaled_as_jax(tmp_path, scale):
    """The intrinsics scaled and the sizes floored, equal to JAX's
    ``InputDataset(..., scale_factor=s)``, and the sizes those of the
    resized images."""
    jout, tout = _outputs(tmp_path, "RGB")
    jcams, tcams = JInputDataset(jout, scale_factor=scale).cameras, InputDataset(tout, scale_factor=scale).cameras
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        want = np.asarray(getattr(jcams, f)).reshape(-1)
        assert np.array_equal(getattr(tcams, f).numpy().reshape(-1), want), f
    assert np.array_equal(tcams.camera_to_worlds.numpy(), np.asarray(jcams.camera_to_worlds).reshape(N, 3, 4))
    assert (int(tcams.width[0, 0]), int(tcams.height[0, 0])) == (int(W * scale), int(H * scale))


def test_scale_one_reads_the_file_unresized(tmp_path):
    """scale_factor 1 keeps the file's bytes and the parser's cameras."""
    jout, tout = _outputs(tmp_path, "RGBA")
    ds = InputDataset(tout)
    assert ds.cameras is tout.cameras
    assert np.array_equal(ds.get_numpy_image(0), np.asarray(Image.open(jout.image_filenames[0])))
    assert np.array_equal(resize_bilinear(ds.get_numpy_image(0), W, H), ds.get_numpy_image(0))
