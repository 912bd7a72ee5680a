"""comet_tpu_torch.ops.topk and ops.distance (plain PyTorch) against the
reference's XLA versions on the CPU, on inputs from a seeded numpy
generator. Bar: integer-valued inputs give array-equal scores and slots;
normal floats give equal slots and scores `allclose(rtol=1e-4, atol=1e-4)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import distance as ref_distance
from comet_tpu.ops import topk as ref_topk
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch.ops import distance, topk
from comet_tpu_torch.types import DistanceKind

KINDS = ["l2", "l2_squared", "cosine"]


def _corpus(seed, n=512, d=8, q_n=9, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(0, 8, size=(n, d)).astype(np.float32)
        q = rng.integers(0, 8, size=(q_n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(q_n, d)).astype(np.float32)
    valid = rng.random(n) > 0.2
    return q, x, valid


def _prep(q, x, kind):
    return (distance.preprocess(q, DistanceKind(kind)),
            distance.preprocess(x, DistanceKind(kind)))


@pytest.mark.parametrize("kind", KINDS)
def test_pairwise_scores_match_reference(kind):
    q, x = _prep(*_corpus(1)[:2], kind)
    want = np.asarray(ref_distance.pairwise_scores(jnp.asarray(q), jnp.asarray(x), RefKind(kind)))
    got = distance.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x), DistanceKind(kind))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_sqrt_is_correctly_rounded():
    v = np.random.default_rng(0).integers(0, 2**24, size=100_000).astype(np.float32)
    np.testing.assert_array_equal(distance.sqrt_f32(torch.from_numpy(v)).numpy(), np.sqrt(v))


def test_preprocess_rejects_zero_vectors():
    from comet_tpu_torch.types import ZeroVectorError

    with pytest.raises(ZeroVectorError):
        distance.preprocess(np.zeros((2, 3), np.float32), DistanceKind.COSINE)


def test_merge_and_topk_lower_keep_tie_order():
    rng = np.random.default_rng(2)
    s = rng.integers(0, 3, size=(6, 40)).astype(np.float32)
    ws, wi = ref_topk.topk_lower(jnp.asarray(s), 12)
    gs, gi = topk.topk_lower(torch.from_numpy(s), 12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    a_i = rng.permutation(80)[:40].reshape(2, 20).astype(np.int32)
    b_i = rng.permutation(80)[:40].reshape(2, 20).astype(np.int32) + 80
    a_s = rng.integers(0, 3, size=(2, 20)).astype(np.float32)
    b_s = rng.integers(0, 3, size=(2, 20)).astype(np.float32)
    ws, wi = ref_topk.merge_topk(*map(jnp.asarray, (a_s, a_i, b_s, b_i)), 25)
    gs, gi = topk.merge_topk(*map(torch.from_numpy, (a_s, a_i, b_s, b_i)), 25)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# normalised integer vectors are not integer-valued: cosine runs on floats
SCANS = [
    (kind, fn, integer)
    for kind in KINDS for fn in ("scan_topk", "block_topk") for integer in (True, False)
    if not (integer and kind == "cosine")
]


@pytest.mark.parametrize("kind,fn,integer", SCANS)
def test_scans_match_reference(kind, fn, integer):
    q, x, valid = _corpus(3, integer=integer)
    q, x = _prep(q, x, kind)
    sq = (x * x).sum(axis=1).astype(np.float32)
    thr = np.float32(np.inf)
    k = 20
    if fn == "scan_topk":
        extra = dict(tile=128)
    else:
        extra = dict(block=32, super_tile=256)
    rs, ri = getattr(ref_topk, fn)(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(thr), k, RefKind(kind), **extra,
    )
    gs, gi = getattr(topk, fn)(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(sq),
        torch.from_numpy(valid), float(thr), k, DistanceKind(kind), **extra,
    )
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    if integer:
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    else:
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-4, atol=1e-4)


def test_block_select_pads_short_tiles():
    dist = torch.tensor([[3.0, 1.0, float("inf"), 2.0]])
    s, i = topk.block_select_from_dist(dist, 6, 2, base=10)
    assert i[0].tolist() == [11, 13, 10] + [topk.IDX_SENTINEL] * 3
    assert torch.isinf(s[0, 3:]).all()
