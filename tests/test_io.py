"""Frame decoding without Pillow, and the synthetic frames of file runs."""

import builtins

import numpy as np
import pytest
from PIL import Image

from correlation_jax.io import load_image, save_png
from synthetic import Speckle


def _smooth(shape, seed):
    """A smooth image, so Pillow's adaptive PNG filters pick every row
    filter type (None, Sub, Up, Average, Paeth)."""
    img = Speckle(shape[0], shape[1], seed=seed).image(quantize=True)
    if len(shape) == 3:
        img = np.stack([img, img[::-1], img[:, ::-1]], -1)
    return img.astype(np.uint8)


def _pillow(path, mono):
    arr = np.asarray(Image.open(path).convert("L" if mono else "RGB"))
    return (arr[..., None] if arr.ndim == 2 else arr).astype(np.float32)


def test_png_decode_matches_pillow_gray(tmp_path):
    path = str(tmp_path / "g.png")
    Image.fromarray(_smooth((53, 61), 1)).save(path)
    for mono in (True, False):
        got = load_image(path, mono)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _pillow(path, mono))


def test_png_decode_matches_pillow_rgb(tmp_path):
    path = str(tmp_path / "c.png")
    Image.fromarray(_smooth((47, 58, 3), 2)).save(path)
    for mono in (True, False):  # mono: Pillow's integer ITU-R 601 luma
        np.testing.assert_array_equal(
            load_image(path, mono), _pillow(path, mono)
        )


def test_save_png_roundtrip_and_npy_frames(tmp_path):
    img = _smooth((40, 33), 3)
    path = str(tmp_path / "w.png")
    save_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(load_image(path)[..., 0], img)
    npy = str(tmp_path / "f.npy")
    np.save(npy, img)
    np.testing.assert_array_equal(load_image(npy)[..., 0], img)
    np.save(npy, img.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        load_image(npy)


def test_other_formats_without_pillow_name_the_format(tmp_path, monkeypatch):
    """A 16-bit PNG or a BMP needs Pillow; without it the error says
    which format, and 8-bit PNGs still load."""
    bmp = str(tmp_path / "f.bmp")
    Image.fromarray(_smooth((20, 24), 4)).save(bmp)
    png16 = str(tmp_path / "d.png")
    Image.fromarray(_smooth((20, 24), 4).astype(np.uint16) * 257).save(png16)
    np.testing.assert_array_equal(load_image(png16), _pillow(png16, True))
    png8 = str(tmp_path / "e.png")
    save_png(png8, _smooth((20, 24), 4))

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match=r"\.bmp needs Pillow"):
        load_image(bmp)
    with pytest.raises(ValueError, match=r"\.png needs Pillow"):
        load_image(png16)
    assert load_image(png8).shape == (20, 24, 1)


def test_speckle_shifted_image_matches_warped_image():
    """The fast translated renderer the file-backed runs use agrees with
    the exact sum of Gaussians to the cut-off's 1e-3 grey levels."""
    spk = Speckle(60, 64, seed=3)
    for u, v in ((0.0, 0.0), (0.3, -0.7), (2.6, 1.1)):
        np.testing.assert_allclose(
            spk.shifted_image(u, v), spk.warped_image(u=u, v=v), atol=2e-3
        )
