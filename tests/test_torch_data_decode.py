"""The port's native decoder (vitta_tpu_torch/csrc/host/vitta_decode.cpp,
built into build/vitta_tpu_torch/) on a video its own encoder writes: frame
count, random access against sequential decode, the ``make_video_source``
"video" kind, a decoded stream through ``PairedTTADataset`` and several
worker threads, and, where vitta_tpu's decoder builds too, every frame and
item bit for bit against vitta_tpu's.  Skipped where libav or g++ is
missing, as tests/test_native_decode.py is.
"""

import numpy as np
import pytest

from vitta_tpu_torch.data import native_decode

if not native_decode.available():
    pytest.skip("libav toolchain unavailable", allow_module_level=True)

N, H, W = 40, 48, 64


def _frames():
    """Frame i is flat at 20 + 5 i, so a decoded frame names its index
    through lossy mpeg4 (within 4)."""
    return np.stack([np.full((H, W, 3), 20 + 5 * i, np.uint8)
                     for i in range(N)])


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    native_decode.write_test_video(str(root / "ramp.avi"), _frames(), fps=10,
                                   gop=7)
    return root


def test_reader_round_trip(video_dir):
    vr = native_decode.NativeVideoReader(str(video_dir / "ramp.avi"))
    try:
        assert len(vr) == N and (vr.height, vr.width) == (H, W)
        seq = vr.get_batch(np.arange(N))
        idx = np.asarray([33, 2, 2, 17, 39, 0])
        np.testing.assert_array_equal(vr.get_batch(idx), seq[idx])
        assert np.abs(seq.reshape(N, -1).mean(1) - (20 + 5 * np.arange(N))
                      ).max() <= 4
        with pytest.raises(IndexError):
            vr.get_batch([N])
    finally:
        vr.close()


def test_frames_and_items_bit_equal_to_vitta_tpu(video_dir):
    import dataclasses

    from vitta_tpu.config import tanet_ucf101_preset as jax_preset
    from vitta_tpu.data import dataset as jax_dataset
    from vitta_tpu.data import native_decode as jax_native_decode
    from vitta_tpu.data import video_reader as jax_reader
    from vitta_tpu_torch.config import tanet_ucf101_preset
    from vitta_tpu_torch.data import dataset, video_reader
    from vitta_tpu_torch.data.records import VideoRecord

    if not jax_native_decode.available():
        pytest.skip("vitta_tpu's decoder does not build here")
    src = video_reader.make_video_source("video", str(video_dir),
                                         vid_format=".avi")
    assert isinstance(src, video_reader.FFmpegVideoSource)
    jsrc = jax_reader.make_video_source("video", str(video_dir),
                                        vid_format=".avi")
    with src, jsrc:
        idx = np.asarray([0, 9, 10, 38, 45])
        assert src.num_frames("ramp") == jsrc.num_frames("ramp") == N
        np.testing.assert_array_equal(src.get_batch("ramp", idx),
                                      jsrc.get_batch("ramp", idx))
        recs = [VideoRecord("ramp", N, 3)]
        cfgs = []
        for preset in (jax_preset, tanet_ucf101_preset):
            cfg = preset()
            cfgs.append(cfg.replace(data=dataclasses.replace(
                cfg.data, clip_length=4, input_size=32, scale_size=40)))
        got = dataset.PairedTTADataset(cfgs[1], src, recs, seed=2,
                                       emit_uint8=True)[0]
        want = jax_dataset.PairedTTADataset(cfgs[0], jsrc, recs, seed=2,
                                            emit_uint8=True)[0]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_threads_share_a_source(video_dir):
    from vitta_tpu_torch.data import video_reader
    from vitta_tpu_torch.data.pipeline import Prefetcher

    class Batches:
        def __init__(self, src):
            self.src = src

        def __len__(self):
            return 12

        def __getitem__(self, i):
            return self.src.get_batch("ramp", np.arange(i, i + 20) % N)

    with video_reader.FFmpegVideoSource(str(video_dir), ".avi") as src:
        want = [Batches(src)[i] for i in range(12)]
        got = list(Prefetcher(Batches(src), device_put=False, n_workers=4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
