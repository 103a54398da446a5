"""The port's datasets, sources and list files against vitta_tpu's, item
for item and bit for bit: ``TANetVideoDataset``, ``SwinVideoDataset`` and
``LegacyVideoDataset`` at ``dataset_type`` tta, eval and raw (and the
legacy ``train``), float32 and uint8, one and three crops, over the
synthetic source and an npy source written to a temporary folder; the
view styles and the spatial crop switch of the TANet views;
``PairedTTADataset`` with the fused decode against the two-call form and
against vitta_tpu's; ``dataset_cls_for``; the sources themselves.

Equal seeds give equal crops in both packages (one
``SeedSequence(entropy=seed, spawn_key=(i,))`` generator per item), so
every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

from vitta_tpu.config import swin_ucf101_preset as jax_swin_preset
from vitta_tpu.config import tanet_ucf101_preset as jax_tanet_preset
from vitta_tpu.data import dataset as jax_dataset
from vitta_tpu.data import records as jax_records
from vitta_tpu.data import video_reader as jax_reader
from vitta_tpu_torch.config import swin_ucf101_preset, tanet_ucf101_preset
from vitta_tpu_torch.data import dataset, records, video_reader
from vitta_tpu_torch.data.records import VideoRecord

T, HW, SCALE = 4, 32, 40
H, W = 60, 80
RECORDS = [VideoRecord(f"video_{i}", n, i % 5)
           for i, n in enumerate((3, 17, 40, 75, 130))]
CLASSES = ("TANetVideoDataset", "SwinVideoDataset", "LegacyVideoDataset")


def _cfgs(cls, data=None, tta=None):
    """(vitta_tpu's config, the port's) of ``cls`` at the tiny size."""
    out = []
    for tanet, swin in ((jax_tanet_preset, jax_swin_preset),
                        (tanet_ucf101_preset, swin_ucf101_preset)):
        cfg = (swin if cls == "SwinVideoDataset" else tanet)()
        out.append(cfg.replace(
            data=dataclasses.replace(cfg.data, clip_length=T, input_size=HW,
                                     scale_size=SCALE, **(data or {})),
            tta=dataclasses.replace(cfg.tta, **(tta or {}))))
    return out


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    """The synthetic videos of ``RECORDS`` stored as npy files."""
    root = tmp_path_factory.mktemp("npy")
    src = jax_reader.SyntheticVideoSource(H, W)
    for rec in RECORDS:
        np.save(root / f"{rec.path}.npy",
                src.get_batch(rec.path, np.arange(rec.num_frames)))
    return str(root)


def _sources(kind, npy_dir):
    if kind == "synthetic":
        return (jax_reader.SyntheticVideoSource(H, W),
                video_reader.SyntheticVideoSource(H, W))
    return jax_reader.NpyVideoSource(npy_dir), video_reader.NpyVideoSource(
        npy_dir)


def _assert_items_equal(want, got):
    assert type(got).__name__ == type(want).__name__ == "Sample"
    assert got.frames.dtype == want.frames.dtype
    assert got.frames.shape == want.frames.shape
    np.testing.assert_array_equal(got.frames, want.frames)
    assert (got.label, got.index) == (want.label, want.index)


def _check(cls, dataset_type, uint8, kind, npy_dir, data=None, tta=None,
           seed=3):
    jcfg, cfg = _cfgs(cls, data, tta)
    jsrc, src = _sources(kind, npy_dir)
    jds = getattr(jax_dataset, cls)(jcfg, jsrc, RECORDS,
                                    dataset_type=dataset_type, seed=seed,
                                    emit_uint8=uint8)
    ds = getattr(dataset, cls)(cfg, src, RECORDS, dataset_type=dataset_type,
                               seed=seed, emit_uint8=uint8)
    assert len(ds) == len(jds) == len(RECORDS)
    for i in range(len(ds)):
        _assert_items_equal(jds[i], ds[i])


CASES = [(cls, dt, u8, kind)
         for cls in CLASSES
         for dt in ("tta", "eval", "raw")
         + (("train",) if cls == "LegacyVideoDataset" else ())
         for u8 in (False, True)
         for kind in ("synthetic", "npy")]


@pytest.mark.parametrize("cls,dataset_type,uint8,kind", CASES)
def test_items_bit_equal(cls, dataset_type, uint8, kind, npy_dir):
    _check(cls, dataset_type, uint8, kind, npy_dir)


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("sample_style", ["uniform-1", "dense-3"])
def test_tanet_eval_three_crops(sample_style, uint8, npy_dir):
    _check("TANetVideoDataset", "eval", uint8, "synthetic", npy_dir,
           data=dict(test_crops=3, sample_style=sample_style))


@pytest.mark.parametrize("spatial_rand", [True, False])
@pytest.mark.parametrize("style", ["uniform_equidist", "dense", "random",
                                   "uniform_rand", "dense_equidist"])
def test_tanet_view_styles(style, spatial_rand, npy_dir):
    _check("TANetVideoDataset", "tta", False, "synthetic", npy_dir,
           tta=dict(tta_view_sample_style=style,
                    if_spatial_rand_cropping=spatial_rand))


@pytest.mark.parametrize("data", [dict(frame_uniform=False, num_clips=2),
                                  dict(frame_uniform=True)])
def test_swin_eval_sampling(data, npy_dir):
    _check("SwinVideoDataset", "eval", True, "synthetic", npy_dir, data=data)


@pytest.mark.parametrize("tsn_style", [False, True])
def test_legacy_samplers(tsn_style, npy_dir):
    for dt in ("train", "eval"):
        _check("LegacyVideoDataset", dt, False, "synthetic", npy_dir,
               data=dict(tsn_style=tsn_style, num_clips=2, frame_interval=2,
                         dataset="somethingv2"))


@pytest.mark.parametrize("uint8", [False, True])
@pytest.mark.parametrize("cls", CLASSES)
def test_paired_fused_decode(cls, uint8, npy_dir):
    """The union decode equals the two-call form and vitta_tpu's pair."""
    jcfg, cfg = _cfgs(cls)
    jsrc, src = _sources("npy", npy_dir)
    kw = dict(seed=11, emit_uint8=uint8)
    fused = dataset.PairedTTADataset(cfg, src, RECORDS,
                                     dataset_cls=getattr(dataset, cls), **kw)
    plain = dataset.PairedTTADataset(cfg, src, RECORDS,
                                     dataset_cls=getattr(dataset, cls),
                                     fuse_decode=False, **kw)
    jpair = jax_dataset.PairedTTADataset(
        jcfg, jsrc, RECORDS, dataset_cls=getattr(jax_dataset, cls), **kw)
    assert len(fused) == len(jpair)
    for i in range(len(RECORDS)):
        got, two, want = fused[i], plain[i], jpair[i]
        for g, p, w in zip(got, two, want):
            assert g.dtype == p.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, w)
        assert got[2].dtype == np.int32 and got[2].shape == (1,)


def test_dataset_cls_for():
    for arch, legacy, name in (("videoswintransformer", False,
                                "SwinVideoDataset"),
                               ("tanet", False, "TANetVideoDataset"),
                               ("i3d", True, "LegacyVideoDataset"),
                               ("i3d", False, "TANetVideoDataset")):
        assert dataset.dataset_cls_for(arch, legacy) is getattr(dataset, name)
        assert jax_dataset.dataset_cls_for(arch, legacy).__name__ == name
    with pytest.raises(ValueError, match="legacy_loader"):
        dataset.dataset_cls_for("tanet", legacy_loader=True)
    with pytest.raises(ValueError, match="dataset_type"):
        dataset.LegacyVideoDataset(_cfgs("LegacyVideoDataset")[1],
                                   video_reader.SyntheticVideoSource(H, W),
                                   RECORDS, dataset_type="views")


def test_list_file_and_records_from_config(tmp_path):
    lines = ["a 40 1", "b 2 0", "c 100 3", "", "bad line"]
    path = tmp_path / "list.txt"
    path.write_text("\n".join(lines) + "\n")
    for kw in (dict(), dict(filter_short=False), dict(debug=True,
                                                       debug_vid=1)):
        got = records.parse_list_file(str(path), **kw)
        want = jax_records.parse_list_file(str(path), **kw)
        assert [(r.path, r.num_frames, r.label) for r in got] == \
            [(r.path, r.num_frames, r.label) for r in want]
    # records=None reads the configured list file
    jcfg, cfg = _cfgs("TANetVideoDataset", data=dict(val_vid_list=str(path)))
    ds = dataset.TANetVideoDataset(cfg, video_reader.SyntheticVideoSource(H, W))
    jds = jax_dataset.TANetVideoDataset(jcfg,
                                        jax_reader.SyntheticVideoSource(H, W))
    assert [r.path for r in ds.records] == [r.path for r in jds.records] \
        == ["a", "c"]
    _assert_items_equal(jds[1], ds[1])


def test_sources_match_vitta_tpus(npy_dir):
    idx = np.asarray([0, 5, 5, 200])
    for kind in ("synthetic", "npy"):
        jsrc, src = _sources(kind, npy_dir)
        for rec in RECORDS:
            assert src.num_frames(rec.path) == jsrc.num_frames(rec.path)
            np.testing.assert_array_equal(src.get_batch(rec.path, idx),
                                          jsrc.get_batch(rec.path, idx))
    src = video_reader.make_video_source("synthetic", height=H, width=W)
    assert isinstance(src, video_reader.SyntheticVideoSource)
    assert isinstance(video_reader.make_video_source("npy", npy_dir),
                      video_reader.NpyVideoSource)
    with pytest.raises(ValueError, match="unknown video source"):
        video_reader.make_video_source("tape")


def test_frame_folder_source(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    frames = video_reader.SyntheticVideoSource(H, W).get_batch(
        "video_1", np.arange(6))
    folder = tmp_path / "video_1"
    folder.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(folder / f"img_{i + 1:05d}.png")
    kw = dict(image_tmpl="img_{:05d}.png")   # lossless, so frames compare
    src = video_reader.make_video_source("frames", str(tmp_path), **kw)
    jsrc = jax_reader.make_video_source("frames", str(tmp_path), **kw)
    assert src.num_frames("video_1") == jsrc.num_frames("video_1") == 6
    idx = np.asarray([0, 2, 5])
    np.testing.assert_array_equal(src.get_batch("video_1", idx), frames[idx])
    np.testing.assert_array_equal(jsrc.get_batch("video_1", idx),
                                  frames[idx])


def test_video_kind_names_both_decoders_when_neither_works(monkeypatch):
    """``make_video_source("video")`` takes the native decoder, else
    decord; with neither its error names what is missing."""
    import builtins

    from vitta_tpu_torch.data import native_decode
    real_import = builtins.__import__

    def no_decord(name, *args, **kw):
        if name == "decord":
            raise ModuleNotFoundError("No module named 'decord'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(native_decode, "available", lambda: False)
    monkeypatch.setattr(builtins, "__import__", no_decord)
    with pytest.raises(RuntimeError, match="libav.*decord"):
        video_reader.make_video_source("video", "/nonexistent")
