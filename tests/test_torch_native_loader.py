"""The port's C++ frame loader (fatezero_tpu_torch/native) against the JAX
package's (fatezero_tpu/native), on synthetic JPEG and PNG frames.

Both compile the same image_loader.cpp with the same flags, so their output
is held bit for bit: at native resolution, downscaled, with a fixed crop. The
port's ImageSequenceDataset equals JAX's in the auto mode (the C++ path where
the source's short side is image_size, PIL elsewhere) and with
native_loader=True (the C++ resampling). Where the library cannot be built,
the auto mode takes the PIL path and native_loader=True raises with the
build's error (JAX falls back to PIL there).
"""
import os

import numpy as np
import pytest
from PIL import Image

from fatezero_tpu import native as jnative
from fatezero_tpu.data.dataset import ImageSequenceDataset as JDataset
from fatezero_tpu_torch import native
from fatezero_tpu_torch.data import dataset as D


@pytest.fixture(scope="module")
def libs():
    if jnative.get_lib() is None:
        pytest.fail("the JAX package's native loader does not build on this host (g++, libjpeg, libpng)")
    native.get_lib()
    return native, jnative


def _write(folder, n, hw, ext, seed=0):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(folder, f"{i:05d}.{ext}")
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(p, **({"quality": 90} if ext == "jpg" else {}))
        paths.append(p)
    return paths


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("size,crop", [(64, None), (48, None), (40, (3, 5))], ids=["native", "down", "crop"])
def test_load_batch_bit_equal_to_jax(libs, tmp_path, ext, size, crop):
    paths = _write(str(tmp_path), 3, (64, 80), ext)
    got = native.load_batch(paths, size, crop_xy=crop)
    want = jnative.load_batch(paths, size, crop_xy=crop)
    assert got.shape == (3, size, size, 3) and got.dtype == np.float32
    assert -1.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_array_equal(got, want)


def test_missing_file_gives_none(libs):
    assert native.load_batch(["/no/such/image.png"], 64) is None


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("hw,size,mode,fast", [
    ((64, 64), 64, None, True),      # auto, exact: the C++ path
    ((64, 80), 48, None, False),     # auto, a resample: PIL
    ((64, 80), 48, True, True),      # asked for: the C++ resampling
    ((64, 64), 64, False, False),    # refused: PIL
], ids=["auto-exact", "auto-resample", "true", "false"])
def test_dataset_matches_jax(libs, tmp_path, monkeypatch, ext, hw, size, mode, fast):
    _write(str(tmp_path), 3, hw, ext)
    counted = _Count(native.load_batch)
    monkeypatch.setattr(native, "load_batch", counted)
    kw = dict(path=str(tmp_path), n_sample_frame=2, sampling_rate=1, image_size=size, native_loader=mode)
    got = D.ImageSequenceDataset(**kw)[0]["images"]
    want = JDataset(**kw)[0]["images"]
    assert counted.calls == int(fast)
    assert got.shape == (2, size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_unbuildable_library(tmp_path, monkeypatch):
    """No library: the auto mode reads with PIL (the same clip as the
    refused mode), native_loader=True raises with the build error, and the
    failure is remembered rather than rebuilt on every clip."""
    _write(str(tmp_path), 2, (64, 64), "png")
    builds = []

    def fail():
        builds.append(1)
        raise native.NativeLoaderUnavailable("g++ failed for image_loader.cpp:\njpeglib.h: No such file or directory")

    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "build", fail)
    kw = dict(path=str(tmp_path), n_sample_frame=2, sampling_rate=1, image_size=64)
    auto = D.ImageSequenceDataset(**kw)[0]["images"]
    np.testing.assert_array_equal(auto, D.ImageSequenceDataset(**kw, native_loader=False)[0]["images"])
    with pytest.raises(native.NativeLoaderUnavailable, match="jpeglib.h"):
        D.ImageSequenceDataset(**kw, native_loader=True)[0]
    with pytest.raises(native.NativeLoaderUnavailable):
        native.load_batch([os.path.join(tmp_path, "00000.png")], 64)
    assert len(builds) == 1
