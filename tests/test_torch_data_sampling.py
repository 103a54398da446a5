"""Every frame sampler of the port (vitta_tpu_torch/data/sampling.py)
against vitta_tpu.data.sampling, index for index, over the frame counts of
tests/test_sampling.py (3 to 999 frames) and clip lengths 4, 8 and 16.

tests/test_sampling.py holds vitta_tpu's samplers to the reference's code,
which it imports from outside the repo; here the port's copy is held to
vitta_tpu's, which needs nothing outside the repo.  The random styles
draw from one seeded ``np.random.Generator`` on each side, so they too
must agree exactly.  Every result is also checked to be a valid decode
index: int64, within [0, n_frames).
"""

import numpy as np
import pytest

from vitta_tpu.data import sampling as jax_sampling
from vitta_tpu_torch.data import sampling

FRAME_COUNTS = [3, 7, 15, 16, 17, 40, 63, 64, 65, 100, 250, 999]
CLIP_LENS = (4, 8, 16)


def _same(name, nf, call):
    """``call(module, rng)`` on both packages with equal seeds, for every
    clip length; the indices must be equal and decodable."""
    for clip_len in CLIP_LENS:
        for seed in (0, 1):
            want = call(jax_sampling, clip_len,
                        np.random.default_rng(seed))
            got = call(sampling, clip_len, np.random.default_rng(seed))
            np.testing.assert_array_equal(
                got, want, err_msg=f"{name} nf={nf} clip_len={clip_len}")
            assert got.dtype == want.dtype
            assert got.min() >= 0 and got.max() < nf, (name, nf, clip_len)


SAMPLERS = {
    "train_tsn": lambda m, nf, c, rng: m.sample_train_tsn(nf, c, rng),
    "train_dense": lambda m, nf, c, rng: m.sample_train_dense(nf, c, rng),
    "val_uniform": lambda m, nf, c, rng: m.sample_val_uniform(nf, c),
    "seq_frames_test": lambda m, nf, c, rng: m.sample_seq_frames(nf, c),
    "seq_frames_train": lambda m, nf, c, rng: m.sample_seq_frames(
        nf, c, test_mode=False, rng=rng),
    "dense_clips": lambda m, nf, c, rng: m.sample_dense_clips_test(
        nf, c, frame_interval=2, num_clips=3),
    "dense_clips_twice": lambda m, nf, c, rng: m.sample_dense_clips_test(
        nf, c, frame_interval=1, num_clips=2, twice_sample=True),
    "legacy_consecutive_test": lambda m, nf, c, rng:
        m.sample_legacy_consecutive(nf, c, frame_interval=2, num_clips=2,
                                    test_mode=True),
    "legacy_consecutive_train": lambda m, nf, c, rng:
        m.sample_legacy_consecutive(nf, c, frame_interval=2, num_clips=2,
                                    rng=rng),
    "legacy_tsn_test": lambda m, nf, c, rng: m.sample_legacy_tsn(
        nf, c, num_clips=2, test_mode=True),
    "legacy_tsn_train": lambda m, nf, c, rng: m.sample_legacy_tsn(
        nf, c, num_clips=2, rng=rng),
}


@pytest.mark.parametrize("nf", FRAME_COUNTS)
@pytest.mark.parametrize("style", ["uniform-1", "uniform-3", "dense-1",
                                   "dense-3", "uniform-10", "dense-10"])
def test_sample_test_matches_vitta_tpu(style, nf):
    _same(f"sample_test {style}", nf,
          lambda m, c, rng: m.sample_test(nf, c, style))


@pytest.mark.parametrize("nf", FRAME_COUNTS)
@pytest.mark.parametrize("style", sampling.TTA_VIEW_STYLES)
def test_sample_tta_views_matches_vitta_tpu(style, nf):
    assert sampling.TTA_VIEW_STYLES == jax_sampling.TTA_VIEW_STYLES
    for n_views in (2, 3):
        _same(f"sample_tta_views {style} x{n_views}", nf,
              lambda m, c, rng: m.sample_tta_views(nf, c, style, n_views,
                                                   rng))


@pytest.mark.parametrize("nf", FRAME_COUNTS)
@pytest.mark.parametrize("name", list(SAMPLERS))
def test_other_samplers_match_vitta_tpu(name, nf):
    _same(name, nf, lambda m, c, rng: SAMPLERS[name](m, nf, c, rng))


def test_unknown_styles_raise_as_in_vitta_tpu():
    with pytest.raises(NotImplementedError):
        sampling.sample_test(64, 8, "strided-2")
    with pytest.raises(NotImplementedError):
        sampling.sample_tta_views(64, 8, "strided", 2)
