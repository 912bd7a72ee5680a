"""comet_tpu_torch.io.siftgen against comet_tpu.io.siftgen: the same
arrays from the same seed, and the statistics tests/test_siftgen.py pins."""

import numpy as np
import pytest

from comet_tpu.io import siftgen as ref_siftgen
from comet_tpu_torch.io import siftgen


@pytest.fixture(scope="module")
def corpus():
    return siftgen.generate(8192, seed=3, keypoints_per_image=2048)


@pytest.fixture(scope="module")
def with_queries():
    return siftgen.generate_with_queries(20_000, 16, seed=5)


@pytest.mark.parametrize("call", [
    lambda m: m.generate(1500, seed=11, image_size=256, keypoints_per_image=700),
    lambda m: m.generate_with_queries(3000, 8, seed=2, image_size=256, anchors_per_image=64),
    lambda m: m.generate_queries(300, image_size=256, keypoints_per_image=300),
], ids=["generate", "generate_with_queries", "generate_queries"])
def test_same_arrays_as_the_reference(call):
    got, want = call(siftgen), call(ref_siftgen)
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_value_range_is_texmex_uint8(corpus):
    assert corpus.dtype == np.float32
    assert corpus.min() >= 0.0 and corpus.max() <= 255.0
    assert np.array_equal(corpus, np.rint(corpus))


def test_energy_matches_unit_norm_x512(corpus):
    energy = (corpus.astype(np.float64) ** 2).sum(axis=1)
    assert abs(energy.mean() / 512.0**2 - 1.0) < 0.03
    assert np.percentile(corpus, 99) < 200


def test_sparsity_from_flat_regions(corpus):
    zero_frac = (corpus == 0).mean()
    assert 0.02 < zero_frac < 0.6


def test_subspace_energy_balance(corpus):
    sub = corpus.reshape(len(corpus), 8, 16).astype(np.float64)
    var = sub.var(axis=(0, 2))
    assert var.min() > 0 and var.max() / var.min() < 8.0


def test_orientation_bin_anisotropy(corpus):
    cells = corpus.reshape(len(corpus), 16, 8)
    bin_energy = (cells.astype(np.float64) ** 2).sum(axis=(0, 1))
    assert bin_energy[0] > bin_energy.mean()


def test_determinism(corpus):
    assert np.array_equal(corpus, siftgen.generate(8192, seed=3, keypoints_per_image=2048))


def test_queries_have_matches(with_queries):
    base, queries = with_queries
    b2 = (base**2).sum(axis=1)
    rng = np.random.default_rng(0)
    typical = float(np.median(np.linalg.norm(
        base[rng.choice(len(base), 512)] - base[rng.choice(len(base), 512)], axis=1)))
    for q in queries:
        d1 = np.sqrt(max(float((b2 - 2.0 * (base @ q)).min() + (q**2).sum()), 0.0))
        assert d1 < 0.7 * typical


def test_with_queries_base_stats_match_generate(with_queries):
    base, queries = with_queries
    assert base.min() >= 0 and base.max() <= 255
    assert queries.min() >= 0 and queries.max() <= 255
    energy = (base.astype(np.float64) ** 2).sum(axis=1)
    assert abs(energy.mean() / 512.0**2 - 1.0) < 0.03


def test_pq_distortion_in_sift_band(corpus):
    rng = np.random.default_rng(0)
    sub = corpus.reshape(len(corpus), 8, 16)
    mse = 0.0
    for j in range(8):
        x = sub[:, j, :].astype(np.float64)
        c = x[rng.choice(len(x), 32, replace=False)].copy()
        for _ in range(8):
            a = ((x[:, None, :] - c[None, :, :]) ** 2).sum(-1).argmin(1)
            for ci in range(32):
                pick = x[a == ci]
                if len(pick):
                    c[ci] = pick.mean(0)
        mse += ((x - c[a]) ** 2).sum(-1).mean()
    assert 20_000 < mse < 150_000
