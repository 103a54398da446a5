"""The port's host library (vitta_tpu_torch/data/native.py over its own
copy of the C++ source) and transforms against vitta_tpu's, bit for bit:
resize with and without antialias, the windowed resize, crop, normalize,
and every transform of vitta_tpu_torch/data/transforms.py from equal
seeds.  Resize also against PIL where PIL imports (within one level, as
tests/test_native.py holds vitta_tpu's).  The port's library is its own
file under build/vitta_tpu_torch/, and it raises, never falls back, where
g++ is missing or fails.
"""

import numpy as np
import pytest

from vitta_tpu.data import native as jax_native
from vitta_tpu.data import transforms as jax_transforms
from vitta_tpu_torch.data import native, transforms

RESIZES = [((240, 320), (256, 341)), ((480, 640), (256, 341)),
           ((240, 320), (224, 224)), ((37, 53), (17, 29)),
           ((60, 80), (100, 133)), ((32, 32), (32, 32))]


def _frames(shape, n=2, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, *shape, 3), dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def jax_library_builds():
    # vitta_tpu falls back to PIL / numpy without its library; the bits
    # compared here are its library's
    assert jax_native.available()


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape,out_size", RESIZES)
def test_resize_bit_equal(shape, out_size, antialias):
    x = _frames(shape)
    got = native.resize_bilinear(x, *out_size, antialias=antialias)
    want = jax_native.resize_bilinear(x, *out_size, antialias=antialias)
    assert got.shape == (2, *out_size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.resize_bilinear(x[0], *out_size, antialias=antialias),
        want[0])


@pytest.mark.parametrize("shape,out_size", RESIZES[:4])
def test_resize_matches_pil(shape, out_size):
    Image = pytest.importorskip("PIL.Image")
    img = _frames(shape, n=1)[0]
    want = np.asarray(Image.fromarray(img).resize(
        (out_size[1], out_size[0]), Image.BILINEAR)).astype(np.int16)
    diff = np.abs(native.resize_bilinear(img, *out_size).astype(np.int16)
                  - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, diff.max()


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape,out_size,window", [
    ((240, 320), (256, 341), (16, 58, 224, 224)),
    ((480, 640), (256, 341), (0, 0, 256, 341)),
    ((37, 53), (40, 57), (3, 5, 30, 40)),
    ((60, 80), (40, 53), (4, 6, 32, 32))])
def test_windowed_resize_bit_equal(shape, out_size, window, antialias):
    x = _frames(shape, seed=1)
    got = native.resize_bilinear_window(x, *out_size, *window,
                                        antialias=antialias)
    np.testing.assert_array_equal(got, jax_native.resize_bilinear_window(
        x, *out_size, *window, antialias=antialias))
    y0, x0, wh, ww = window
    full = native.resize_bilinear(x, *out_size, antialias=antialias)
    np.testing.assert_array_equal(got, full[:, y0:y0 + wh, x0:x0 + ww])


def test_crop_and_normalize_bit_equal():
    x = _frames((20, 24), seed=2)
    got = native.crop(x, 3, 4, 10, 12)
    np.testing.assert_array_equal(got, jax_native.crop(x, 3, 4, 10, 12))
    np.testing.assert_array_equal(got, native.crop_reference(x, 3, 4, 10, 12))
    for mean, std, div in (((0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                            True),
                           ((123.675, 116.28, 103.53),
                            (58.395, 57.12, 57.375), False)):
        got_n = native.normalize(x, mean, std, div255=div)
        assert got_n.dtype == np.float32
        np.testing.assert_array_equal(
            got_n, jax_native.normalize(x, mean, std, div255=div))
        np.testing.assert_allclose(
            got_n, native.normalize_reference(x, mean, std, div255=div),
            rtol=1e-5, atol=1e-5)


def test_bad_inputs_raise():
    x = _frames((20, 24))
    with pytest.raises(TypeError, match="uint8"):
        native.resize_bilinear(x.astype(np.float32), 10, 10)
    with pytest.raises(ValueError, match="outside"):
        native.crop(x, 15, 0, 10, 12)
    with pytest.raises(ValueError, match="outside"):
        native.resize_bilinear_window(x, 30, 30, 25, 0, 10, 10)
    with pytest.raises(ValueError, match="channels"):
        native.normalize(x, (0.5, 0.5), (0.5, 0.5))


def test_library_is_the_ports_own():
    path = native.build_library("vitta_host")
    assert path.parent == native.BUILD_DIR
    assert path.parts[-2:-1] == ("vitta_tpu_torch",)
    assert path.name.startswith("libvitta_host_") and path.suffix == ".so"
    assert path.name != "libvitta_host.so"


def test_no_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_LOADED", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.resize_bilinear(_frames((8, 8)), 4, 4)
    assert not list(tmp_path.iterdir())


def test_failing_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "vitta_host.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LOADED", {})
    monkeypatch.setattr(native, "HOST_SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.crop(_frames((8, 8)), 0, 0, 4, 4)
    assert not list((tmp_path / "build").glob("*"))


# --- transforms, from equal seeds -------------------------------------------

def _both(call, seed=5):
    return (call(jax_transforms, np.random.default_rng(seed)),
            call(transforms, np.random.default_rng(seed)))


def _assert_same(pair):
    want, got = pair
    if isinstance(want, tuple):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _assert_same((w, g))
        return
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


CLIP = _frames((60, 80), n=4, seed=3)
VIEWS = _frames((60, 80), n=6, seed=4).reshape(2, 3, 60, 80, 3)

TRANSFORMS = {
    "resize_shorter_side": lambda m, rng: m.resize_shorter_side(CLIP[0], 40),
    "resize_shorter_side_same": lambda m, rng: m.resize_shorter_side(
        CLIP[0], 60),
    "center_crop": lambda m, rng: m.center_crop(CLIP[0], 32),
    "crop_and_resize": lambda m, rng: m.crop_and_resize(CLIP, (5, 7, 40, 30),
                                                        (32, 32)),
    "sample_multiscale_crop": lambda m, rng: tuple(
        m.sample_multiscale_crop(80, 60, (32, 32), rng) for _ in range(5)),
    "subgroupwise_multiscale_crop": lambda m, rng:
        m.subgroupwise_multiscale_crop(VIEWS, 32, rng),
    "scale_center_crop": lambda m, rng: m.scale_center_crop(CLIP, 40, 32),
    "scale_center_crop_no_resize": lambda m, rng: m.scale_center_crop(
        CLIP, 60, 32),
    "scale_center_crop_portrait": lambda m, rng: m.scale_center_crop(
        np.ascontiguousarray(CLIP.transpose(0, 2, 1, 3)), 40, 32),
    "full_res_3crop": lambda m, rng: m.full_res_3crop(CLIP, 32, 40),
    "oversample_10crop": lambda m, rng: m.oversample_10crop(CLIP, 32, 40),
    "subgroupwise_hflip": lambda m, rng: m.subgroupwise_hflip(
        VIEWS, 3, None, rng),
    "subgroupwise_hflip_mapped": lambda m, rng: m.subgroupwise_hflip(
        VIEWS, 86, m.SSV2_LABEL_FLIP, rng),
    "random_resized_crop_bbox": lambda m, rng: tuple(
        m.random_resized_crop_bbox(60, 80, rng) for _ in range(5)),
    "hflip_with_label_swap": lambda m, rng: tuple(
        m.hflip_with_label(CLIP, 86, m.SSV2_LABEL_FLIP, rng, mode="swap")
        for _ in range(4)),
    "hflip_with_label_skip": lambda m, rng: m.hflip_with_label(
        CLIP, 86, m.SSV2_LABEL_FLIP, rng),
    "train_augment": lambda m, rng: m.train_augment(
        CLIP, 93, 32, rng, label_transforms=m.SSV2_LABEL_FLIP),
    "normalize_clip_tanet": lambda m, rng: m.normalize_clip(
        CLIP, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "normalize_clip_swin": lambda m, rng: m.normalize_clip(
        CLIP, (123.675, 116.28, 103.53), (58.395, 57.12, 57.375),
        scale_255=False),
    "normalize_clip_float": lambda m, rng: m.normalize_clip(
        CLIP.astype(np.float32), (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225)),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transforms_bit_equal(name):
    _assert_same(_both(TRANSFORMS[name]))


def test_label_flip_map_is_vitta_tpus():
    from vitta_tpu.config import label_flip_map as jax_label_flip_map
    from vitta_tpu_torch.config import label_flip_map
    for dataset in ("somethingv2", "ucf101", "kinetics"):
        assert label_flip_map(dataset) == jax_label_flip_map(dataset)
    assert transforms.SSV2_LABEL_FLIP == jax_transforms.SSV2_LABEL_FLIP
