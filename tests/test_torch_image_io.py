"""The port's image-file loading (``data/dataset.py``, ``runtime/``) against
the JAX package's, on PNG, PPM and JPEG files the tests write: ``load_image``
(PIL) equal to JAX's, in float and uint8 modes, at the model's size and
resized; ``load_image_batch`` equal to JAX's where no resize is needed (both
routes are exact there); the native loader's half-pixel bilinear resize; the
PIL fallback for what the native decoder rejects; and a build of the native
loader that several processes can start at once."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from fpn_mt_image_captioning_tpu.data import dataset as jx_dataset
from fpn_mt_image_captioning_torch.data import dataset as pt_dataset
from fpn_mt_image_captioning_torch.runtime import native_loader

REPO = Path(__file__).resolve().parents[1]
SIZE = 48


def write_ppm(path, arr):
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode() + arr.tobytes())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """RGB PNG, gray PNG and PPM at the model's size, and a resized RGB PNG."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    out = {"png_rgb": str(d / "rgb.png"), "png_gray": str(d / "gray.png"),
           "ppm": str(d / "img.ppm"), "png_resize": str(d / "big.png")}
    Image.fromarray(rgb).save(out["png_rgb"])
    Image.fromarray(rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8), "L").save(out["png_gray"])
    write_ppm(out["ppm"], rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (80, 64, 3), dtype=np.uint8)).save(out["png_resize"])
    return out


@pytest.mark.parametrize("as_uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("name", ["png_rgb", "png_gray", "ppm", "png_resize"])
def test_load_image_matches_jax(files, name, as_uint8):
    got, cap = pt_dataset.load_image(files[name], "c", SIZE, as_uint8=as_uint8)
    want, _ = jx_dataset.load_image(files[name], "c", SIZE, as_uint8=as_uint8)
    assert cap == "c" and got.shape == (SIZE, SIZE, 3)
    assert got.dtype == (np.uint8 if as_uint8 else np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_uint8", [False, True], ids=["float", "uint8"])
def test_load_image_batch_matches_jax(files, as_uint8):
    paths = [files["png_rgb"], files["png_gray"], files["ppm"]]
    got = pt_dataset.load_image_batch(paths, SIZE, num_workers=2, as_uint8=as_uint8)
    want = jx_dataset.load_image_batch(paths, SIZE, num_workers=2, as_uint8=as_uint8)
    assert got.shape == (3, SIZE, SIZE, 3) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6)
    if as_uint8:   # at the model's size the pixels come back exactly
        np.testing.assert_array_equal(got[0], np.asarray(Image.open(paths[0])))


def test_jpeg_falls_back_to_pil(files, tmp_path):
    """JPEG is outside the native decoder; the batch takes PIL for it, in
    place, beside natively decoded files."""
    jpg = str(tmp_path / "a.jpg")
    Image.open(files["png_rgb"]).save(jpg, quality=90)
    got = pt_dataset.load_image_batch([files["png_rgb"], jpg], SIZE, num_workers=2)
    np.testing.assert_allclose(got[1], jx_dataset.load_image(jpg, None, SIZE)[0], atol=1e-6)
    np.testing.assert_allclose(got[0], jx_dataset.load_image(files["png_rgb"], None, SIZE)[0],
                               atol=1e-6)


def test_native_resize_is_half_pixel_bilinear(files):
    if not native_loader.available():
        pytest.skip("native toolchain (g++, zlib) unavailable")
    out, ok = native_loader.decode_batch([files["png_resize"], "/nonexistent.png"], SIZE)
    assert ok.tolist() == [True, False] and not out[1].any()
    src = np.asarray(Image.open(files["png_resize"])).astype(np.float64)
    h, w = src.shape[:2]
    fy = np.maximum((np.arange(SIZE) + 0.5) * h / SIZE - 0.5, 0.0)
    fx = np.maximum((np.arange(SIZE) + 0.5) * w / SIZE - 0.5, 0.0)
    y0 = np.minimum(fy.astype(int), h - 1)
    x0 = np.minimum(fx.astype(int), w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    wy, wx = (fy - y0)[:, None, None], (fx - x0)[None, :, None]
    want = (src[y0][:, x0] * (1 - wy) * (1 - wx) + src[y0][:, x1] * (1 - wy) * wx
            + src[y1][:, x0] * wy * (1 - wx) + src[y1][:, x1] * wy * wx) / 127.5 - 1.0
    np.testing.assert_allclose(out[0], want, atol=1e-4)


def test_native_build_is_atomic_across_processes(tmp_path):
    """Four processes that find no library build it at once: each loads a
    whole one (the build writes a temporary file and renames it under a file
    lock), and one library is left."""
    if not native_loader.available():
        pytest.skip("native toolchain (g++, zlib) unavailable")
    code = ("import sys; from pathlib import Path\n"
            "from fpn_mt_image_captioning_torch.runtime import native_loader as nl\n"
            "nl.BUILD_DIR = Path(sys.argv[1])\n"
            "print(nl.available(), nl.library_path().name)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert {o.split()[0] for o, _ in outs} == {"True"}
    libs = sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".so")
    assert libs == [outs[0][0].split()[1]]
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]
