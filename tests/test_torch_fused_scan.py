"""comet_tpu_torch.ops.fused_scan (K2 fused scan + pipeline) against the
reference's Pallas `fused_dist_select` and `flat_topk_pipeline`, run in
interpret mode on the CPU, and against the reference's XLA `block_topk`
where an interpret-mode run would cost more than a minute of compile.

Shapes follow the reference's asserts (Q a multiple of 256, N of 2048),
d = 16. Inputs come from a seeded numpy generator and go to both packages.
Bars: on integer-valued inputs every distance is exact in float32, so
dist, ids and scores are array-equal; on normal floats ids are equal and
scores `allclose(rtol=1e-4, atol=1e-4)`, the reference's own bar
(tests/test_pallas_scan.py).
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import pallas_scan as ref
from comet_tpu.ops import topk as ref_topk
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch.ops import fused_scan, topk
from comet_tpu_torch.types import DistanceKind

D = 16
KB = 16


def _data(q_n, n, cosine, seed):
    rng = np.random.default_rng(seed)
    if cosine:
        q = rng.normal(size=(q_n, D)).astype(np.float32)
        x = rng.normal(size=(n, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    else:
        # small integers: exact distances with many exact ties
        q = rng.integers(0, 16, size=(q_n, D)).astype(np.float32)
        x = rng.integers(0, 16, size=(n, D)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[::7] = False
    base = np.zeros(n, np.float32) if cosine else (x * x).sum(axis=1)
    mask = np.where(valid, base, np.inf).astype(np.float32)
    return q, x, mask


def _jax_args(q, x, mask, thr):
    return (jnp.asarray(q), jnp.asarray(np.ascontiguousarray(x.T)),
            jnp.asarray(mask), jnp.asarray(np.float32(thr)))


def _torch_args(q, x, mask):
    return torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(mask)


# -- fused_dist_select ---------------------------------------------------------

FDS_THR = {False: 1200.0, True: 1.0}   # finite thresholds that cut some rows


@lru_cache(maxsize=None)
def _ref_fds(cosine):
    q, x, mask = _data(256, 2048, cosine, seed=11)
    dist, gsel = ref.fused_dist_select(
        *_jax_args(q, x, mask, FDS_THR[cosine]), KB, cosine=cosine, interpret=True
    )
    return np.asarray(dist), np.asarray(gsel)[0].T  # gsel -> [Q, kb]


@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cosine"])
def test_fused_dist_select_matches_reference(cosine):
    q, x, mask = _data(256, 2048, cosine, seed=11)
    rdist, rgsel = _ref_fds(cosine)
    dist, gsel = fused_scan.fused_dist_select(
        *_torch_args(q, x, mask), FDS_THR[cosine], KB, cosine
    )
    dist, gsel = dist.numpy(), gsel.numpy()
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(rdist))
    assert np.isinf(dist[:, ::7]).all()          # masked rows stay +inf
    if cosine:
        fin = np.isfinite(rdist)
        np.testing.assert_allclose(dist[fin], rdist[fin], rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(dist, rdist)
        np.testing.assert_array_equal(np.sort(gsel, axis=1), np.sort(rgsel, axis=1))
    # gsel is the exact top-kb of the group minima, in (min, group id) order
    gmin = dist.reshape(256, -1, fused_scan.GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(gmin.shape[1]), gmin.shape), gmin), axis=1)
    np.testing.assert_array_equal(gsel, order[:, :KB])


@lru_cache(maxsize=None)
def _ref_fds_bf16(cosine):
    q, x, mask = _bf16_scan_data(cosine)
    corpus_t = jnp.asarray(np.ascontiguousarray(x.T)).astype(jnp.bfloat16)
    dist, gsel = ref.fused_dist_select(
        jnp.asarray(q), corpus_t, jnp.asarray(mask), jnp.asarray(np.float32(FDS_THR[cosine])), KB,
        cosine=cosine, interpret=True)
    return np.asarray(dist), np.asarray(gsel)[0].T


def _bf16_scan_data(cosine):
    """Exact in bf16: small integers (L2) or four +-0.5 entries (cosine)."""
    if not cosine:
        return _data(256, 2048, False, seed=12)
    rng = np.random.default_rng(13)
    q, x = _signs(rng, 256), _signs(rng, 2048)
    valid = np.ones(2048, dtype=bool)
    valid[::7] = False
    return q, x, np.where(valid, 0.0, np.inf).astype(np.float32)


@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cosine"])
def test_fused_dist_select_bf16_matches_reference(cosine):
    """K2's bf16 operand (its plain version here) against the reference's
    kernel over a bf16 corpus in interpret mode: dist array-equal, the same
    groups in (min, id) order; qn from the float32 queries."""
    q, x, mask = _bf16_scan_data(cosine)
    rdist, rgsel = _ref_fds_bf16(cosine)
    qt, xt, mt = _torch_args(q, x, mask)
    dist, gsel = fused_scan.fused_dist_select(qt, xt.to(torch.bfloat16), mt, FDS_THR[cosine],
                                              KB, cosine)
    np.testing.assert_array_equal(dist.numpy(), rdist)
    np.testing.assert_array_equal(np.sort(gsel.numpy(), axis=1), np.sort(rgsel, axis=1))
    assert np.isinf(rdist[:, ::7]).all() and np.isfinite(rdist).any()
    # bf16 products, float32 query norms: a query off the bf16 grid
    qo = torch.from_numpy(q) + 1.0 / 512
    d_off = fused_scan.fused_dist_select(qo, xt.to(torch.bfloat16), mt, np.inf, KB, cosine)[0]
    ip = qo.to(torch.bfloat16).float() @ xt.to(torch.bfloat16).float().T
    want = ((1.0 - ip.clamp(-1, 1)) + mt if cosine
            else torch.clamp_min(((qo * qo).sum(1, keepdim=True) + mt) - 2.0 * ip, 0.0))
    fin = torch.isfinite(want)
    torch.testing.assert_close(d_off[fin], want[fin], rtol=1e-6, atol=1e-4)


# Ragged shapes: Q = 129 (the port takes any Q; the reference runs 256
# queries, the first 129 of which are these) and d = 3.
RAGGED_Q, RAGGED_D = 129, 3
RAGGED_THR = {"l2": 60.0, "cosine": 1.0, "bf16": 60.0}


def _ragged_data(mode):
    rng = np.random.default_rng(40)
    q = np.zeros((256, RAGGED_D), np.float32)
    if mode == "cosine":
        q[:RAGGED_Q] = rng.normal(size=(RAGGED_Q, RAGGED_D))
        q[:RAGGED_Q] /= np.linalg.norm(q[:RAGGED_Q], axis=1, keepdims=True)
        x = rng.normal(size=(2048, RAGGED_D)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        base = np.zeros(2048, np.float32)
    else:
        q[:RAGGED_Q] = rng.integers(0, 16, size=(RAGGED_Q, RAGGED_D))
        x = rng.integers(0, 16, size=(2048, RAGGED_D)).astype(np.float32)
        base = (x * x).sum(axis=1)
    valid = np.ones(2048, dtype=bool)
    valid[::7] = False
    return q, x, np.where(valid, base, np.inf).astype(np.float32)


@lru_cache(maxsize=None)
def _ref_ragged(mode):
    q, x, mask = _ragged_data(mode)
    corpus_t = jnp.asarray(np.ascontiguousarray(x.T))
    if mode == "bf16":
        corpus_t = corpus_t.astype(jnp.bfloat16)
    dist, gsel = ref.fused_dist_select(
        jnp.asarray(q), corpus_t, jnp.asarray(mask), jnp.asarray(np.float32(RAGGED_THR[mode])),
        KB, cosine=mode == "cosine", interpret=True)
    return np.asarray(dist)[:RAGGED_Q], np.asarray(gsel)[0].T[:RAGGED_Q]


@pytest.mark.parametrize("mode", ["l2", "cosine", "bf16"])
def test_fused_dist_select_ragged_q_and_d_match_reference(mode):
    """Q = 129 and d = 3, the ragged edges of the kernel's tile: the plain
    version, which the card holds the kernel to, against the reference's
    kernel in interpret mode (exact data: dist array-equal; cosine on normal
    floats: the reference's bar), the kept groups in (min, id) order."""
    q, x, mask = _ragged_data(mode)
    rdist, rgsel = _ref_ragged(mode)
    qt, xt, mt = _torch_args(np.ascontiguousarray(q[:RAGGED_Q]), x, mask)
    if mode == "bf16":
        xt = xt.to(torch.bfloat16)
    dist, gsel = fused_scan.fused_dist_select(qt, xt, mt, RAGGED_THR[mode], KB, mode == "cosine")
    dist, gsel = dist.numpy(), gsel.numpy()
    assert dist.shape == (RAGGED_Q, 2048) and gsel.shape == (RAGGED_Q, KB)
    np.testing.assert_array_equal(np.isinf(dist), np.isinf(rdist))
    assert np.isinf(dist[:, ::7]).all() and np.isfinite(dist).any()
    if mode == "cosine":
        fin = np.isfinite(rdist)
        np.testing.assert_allclose(dist[fin], rdist[fin], rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(dist, rdist)
        np.testing.assert_array_equal(np.sort(gsel, axis=1), np.sort(rgsel, axis=1))
    gmin = dist.reshape(RAGGED_Q, -1, fused_scan.GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(gmin.shape[1]), gmin.shape), gmin), axis=1)
    np.testing.assert_array_equal(gsel, order[:, :KB])


def test_pipeline_bf16_matches_float32_on_exact_data():
    """flat_topk_pipeline over a bf16 corpus equals the float32 pipeline
    where bf16 holds the data exactly."""
    q, x, mask = _data(300, 4096, False, seed=14)
    qt, xt, mt = _torch_args(q, x, mask)
    want = fused_scan.flat_topk_pipeline(qt, xt, mt, 500.0, 10, sqrt_out=True)
    got = fused_scan.flat_topk_pipeline(qt, xt.to(torch.bfloat16), mt, 500.0, 10, sqrt_out=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="float32 corpus"):
        fused_scan.fused_dist_select(qt[:4], xt.to(torch.bfloat16), mt, 1.0, 4,
                                     assign=torch.zeros(4096, dtype=torch.int32),
                                     probes=torch.zeros((4, 1), dtype=torch.int32), nlist=1)


def test_infinite_mask_survives_epilogue():
    """+inf rows stay +inf through max(qn + inf - 2ip, 0) and the threshold."""
    q = torch.full((3, 4), 100.0)
    x = torch.full((128, 4), -100.0)
    mask = torch.full((128,), float("inf"))
    mask[5] = (x[5] * x[5]).sum()
    dist, gsel = fused_scan.fused_dist_select(q, x, mask, float("inf"), 1)
    assert torch.isinf(dist[:, torch.arange(128) != 5]).all()
    assert torch.isfinite(dist[:, 5]).all()
    assert gsel.tolist() == [[0]] * 3


# -- flat_topk_pipeline ----------------------------------------------------------
#
# The reference's Pallas pipeline in interpret mode compiles its sort network
# once per k and metric (k = 100 alone costs over a minute of CPU compile),
# so it runs once, at k = 10, L2: that run serves k = 1 too (an exact top-1 is
# the first of the exact top-10) and the threshold cases. k = 100 and cosine
# are held to the reference's exact XLA pipeline, `comet_tpu.ops.topk.
# block_topk`; their stages are held to the Pallas kernels above (cosine
# distances) and in test_torch_sortnet.py (the k = 100 select).

PIPE_THR = 200.0   # cuts part of the corpus


@lru_cache(maxsize=None)
def _ref_pipe(thr, shift=0.0):
    q, x, mask = _data(256, 2048, False, seed=10)
    s, i = ref.flat_topk_pipeline(
        *_jax_args(q + shift, x, mask, thr), 10, sqrt_out=True, interpret=True
    )
    return np.asarray(s), np.asarray(i)


def _ref_block_topk(q, x, mask, k, cosine):
    """The reference's XLA pipeline, no threshold; L2 scores are distances."""
    rs, ri = ref_topk.block_topk(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray((x * x).sum(axis=1)),
        jnp.asarray(np.isfinite(mask)), jnp.asarray(np.float32(np.inf)), k,
        RefKind.COSINE if cosine else RefKind.L2,
    )
    return np.asarray(rs), np.asarray(ri)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_pipeline_l2_matches_reference(k):
    q, x, mask = _data(256, 2048, False, seed=10)
    if k == 100:
        thr = np.inf
        rs, ri = _ref_block_topk(q, x, mask, k, cosine=False)
    else:
        thr = PIPE_THR
        rs, ri = (a[:, :k] for a in _ref_pipe(thr))
    s, i = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), thr, k, sqrt_out=True)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(s.numpy(), rs)
    if k == 10:
        assert (i.numpy() == fused_scan.IDX_SENTINEL).any()   # the threshold cut


def test_pipeline_threshold_empties_everything():
    q, x, mask = _data(256, 2048, False, seed=10)
    rs, ri = _ref_pipe(1e-12, shift=100.0)
    s, i = fused_scan.flat_topk_pipeline(
        *_torch_args(q + 100.0, x, mask), 1e-12, 10, sqrt_out=True
    )
    assert torch.isinf(s).all() and (i == fused_scan.IDX_SENTINEL).all()
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(s.numpy(), rs)


def test_pipeline_cosine_two_chunks_matches_reference():
    """512 queries run as two chunks; normal floats, the reference's bar."""
    q, x, mask = _data(512, 2048, True, seed=5)
    rs, ri = _ref_block_topk(q, x, mask, 10, cosine=True)
    s, i = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), np.inf, 10, cosine=True)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_allclose(s.numpy(), rs, rtol=1e-4, atol=1e-4)


def test_pipeline_ragged_query_count():
    """The port takes any query count (the reference pads to 256)."""
    q, x, mask = _data(300, 2048, False, seed=3)
    s, i = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), np.inf, 7)
    s2, i2 = fused_scan.flat_topk_pipeline(*_torch_args(q[256:], x, mask), np.inf, 7)
    np.testing.assert_array_equal(i.numpy()[256:], i2.numpy())
    np.testing.assert_array_equal(s.numpy()[256:], s2.numpy())


@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cosine"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_pipeline_matches_block_topk(k, cosine):
    """The kernels' pipeline against the plain one, ops/topk.block_topk,
    which the card tests hold it to as well: 300 queries, two chunks."""
    q, x, mask = _data(300, 4096, cosine, seed=20 + k)
    thr = 1.0 if cosine else 500.0
    s, i = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), thr, k, cosine=cosine)
    qt, xt, mt = _torch_args(q, x, mask)
    kind = DistanceKind.COSINE if cosine else DistanceKind.L2_SQUARED
    ws, wi = topk.block_topk(qt, xt, (xt * xt).sum(dim=1), torch.isfinite(mt), thr, k, kind)
    np.testing.assert_array_equal(i.numpy(), wi.numpy())
    if cosine:
        np.testing.assert_allclose(s.numpy(), ws.numpy(), rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(s.numpy(), ws.numpy())


def test_other_devices_raise():
    q = torch.zeros((2, 4), device="meta")
    x = torch.zeros((128, 4), device="meta")
    with pytest.raises(ValueError):
        fused_scan.fused_dist_select(q, x, torch.zeros(128, device="meta"), 1.0, 1)


# -- nprobe (IVF) mode and ivf_topk_pipeline -------------------------------------
#
# Integer data for L2; for cosine, vectors with four entries of +-1 and the
# rest 0, whose normalised entries are +-0.5, so every cosine is exact too.
# Centroids are integer-valued (L2) or such vectors (cosine), so the coarse
# ranking is exact and both packages probe the same clusters.

NLIST = 16


def _signs(rng, n):
    v = np.zeros((n, D), np.float32)
    for r in range(n):
        v[r, rng.choice(D, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return v


def _ivf_data(q_n, n, cosine, seed):
    rng = np.random.default_rng(seed)
    if cosine:
        q, x, c = _signs(rng, q_n), _signs(rng, n), _signs(rng, NLIST)
    else:
        q = rng.integers(0, 16, size=(q_n, D)).astype(np.float32)
        x = rng.integers(0, 16, size=(n, D)).astype(np.float32)
        c = rng.integers(0, 16, size=(NLIST, D)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    valid[::7] = False
    base = np.zeros(n, np.float32) if cosine else (x * x).sum(axis=1)
    mask = np.where(valid, base, np.inf).astype(np.float32)
    assign = rng.integers(-1, NLIST, size=n).astype(np.int32)   # -1: no list
    return q, x, mask, c, assign


def _probes(q_n, nprobe, width, seed):
    """Distinct random probes, padded to `width` by repeating probe 0."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.permutation(NLIST)[:nprobe] for _ in range(q_n)]).astype(np.int32)
    return np.concatenate([p, np.repeat(p[:, :1], width - nprobe, axis=1)], axis=1)


@lru_cache(maxsize=None)
def _ref_fds_nprobe(cosine):
    q, x, mask, _, assign = _ivf_data(256, 2048, cosine, seed=30)
    probes = _probes(256, 3, 8, seed=31)
    dist, gsel = ref.fused_dist_select(
        *_jax_args(q, x, mask, FDS_THR[cosine]), KB, cosine=cosine,
        assign=jnp.asarray(assign), probes=jnp.asarray(probes), nprobe=8, interpret=True,
    )
    return np.asarray(dist), np.asarray(gsel)[0].T


@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cosine"])
def test_fused_dist_select_nprobe_mode_matches_reference(cosine):
    """Exact data: dist array-equal, the same kept groups, in (min, id) order."""
    q, x, mask, _, assign = _ivf_data(256, 2048, cosine, seed=30)
    probes = _probes(256, 3, 8, seed=31)
    rdist, rgsel = _ref_fds_nprobe(cosine)
    dist, gsel = fused_scan.fused_dist_select(
        *_torch_args(q, x, mask), FDS_THR[cosine], KB, cosine,
        assign=torch.from_numpy(assign), probes=torch.from_numpy(probes), nlist=NLIST,
    )
    dist, gsel = dist.numpy(), gsel.numpy()
    np.testing.assert_array_equal(dist, rdist)
    np.testing.assert_array_equal(np.sort(gsel, axis=1), np.sort(rgsel, axis=1))
    gmin = dist.reshape(256, -1, fused_scan.GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(gmin.shape[1]), gmin.shape), gmin), axis=1)
    np.testing.assert_array_equal(gsel, order[:, :KB])
    # unprobed clusters and unassigned rows are +inf for every query
    member = (assign[None, :, None] == probes[:, None, :]).any(axis=2)
    assert np.isinf(dist[~member]).all() and np.isinf(dist[:, assign < 0]).all()


def test_probe_words_match_membership():
    """The kernel's probe bitmask and the plain membership table agree,
    nlist not a multiple of 32 included."""
    rng = np.random.default_rng(4)
    nlist = 70
    probes = torch.from_numpy(rng.integers(0, nlist, size=(9, 5)).astype(np.int32))
    assign = torch.from_numpy(rng.integers(-1, nlist, size=300).astype(np.int32))
    words = fused_scan._probe_words(probes, nlist)
    assert words.shape == (9, 3) and words.dtype == torch.int32
    w = words.to(torch.int64) & 0xFFFFFFFF
    a = assign.clamp_min(0).long()
    bit = (w[:, a >> 5] >> (a & 31)) & 1
    want = fused_scan._probe_member(probes, assign, nlist)
    assert torch.equal((bit == 1) & (assign >= 0), want)


IVF_K = 8   # one k for the interpret-mode pipelines: each k is its own compile


@lru_cache(maxsize=None)
def _ref_ivf(cosine, nprobe, thr):
    q, x, mask, c, assign = _ivf_data(256, 2048, cosine, seed=32)
    s, i = ref.ivf_topk_pipeline(
        *_jax_args(q, x, mask, thr), jnp.asarray(c), jnp.asarray(assign), IVF_K, nprobe,
        coarse_cosine=cosine, cosine=cosine, sqrt_out=not cosine, interpret=True,
    )
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("cosine,nprobe,thr", [
    (False, 3, 150.0),        # npad 8 > nprobe; a threshold that cuts
    (False, 3, np.inf),
    (True, 5, 0.75),
], ids=["l2-threshold", "l2", "cosine-threshold"])
def test_ivf_topk_pipeline_matches_reference(cosine, nprobe, thr):
    """Exact data: ids and scores array-equal to the interpret-mode
    reference pipeline (probe padding by repeating probe 0 included)."""
    q, x, mask, c, assign = _ivf_data(256, 2048, cosine, seed=32)
    rs, ri = _ref_ivf(cosine, nprobe, thr)
    s, i = fused_scan.ivf_topk_pipeline(
        *_torch_args(q, x, mask), thr, torch.from_numpy(c), torch.from_numpy(assign),
        IVF_K, nprobe, coarse_cosine=cosine, cosine=cosine, sqrt_out=not cosine,
    )
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(s.numpy(), rs)
    if np.isfinite(thr) and not cosine:
        assert (i.numpy() == fused_scan.IDX_SENTINEL).any()   # the threshold cut


def test_ivf_topk_pipeline_probes_and_few_lists():
    """nlist < 8: the probe width stays 8 (probe 0 repeated). Held to a
    numpy oracle: exact top-k over the rows of the probed clusters, ties to
    the lower slot, probes ranked by (cn - 2 cq, centroid id)."""
    rng = np.random.default_rng(8)
    q = rng.integers(0, 16, size=(40, D)).astype(np.float32)
    x = rng.integers(0, 16, size=(1024, D)).astype(np.float32)
    c = rng.integers(0, 16, size=(4, D)).astype(np.float32)
    c[3] = c[1]                                    # a coarse tie: cluster 1 wins
    assign = rng.integers(0, 4, size=1024).astype(np.int32)
    mask = (x * x).sum(axis=1)
    probes = fused_scan.coarse_probes(torch.from_numpy(q), torch.from_numpy(c), 2, False, 8)
    cd = (c * c).sum(axis=1)[None, :] - 2.0 * q @ c.T
    want_p = np.lexsort((np.broadcast_to(np.arange(4), cd.shape), cd), axis=1)[:, :2]
    np.testing.assert_array_equal(probes.numpy()[:, :2], want_p)
    np.testing.assert_array_equal(probes.numpy()[:, 2:], np.repeat(want_p[:, :1], 6, axis=1))
    s, i = fused_scan.ivf_topk_pipeline(
        *_torch_args(q, x, mask), np.inf, torch.from_numpy(c), torch.from_numpy(assign), 10, 2)
    d2 = (q * q).sum(axis=1)[:, None] + mask[None, :] - 2.0 * q @ x.T
    d2 = np.where((assign[None, :, None] == want_p[:, None, :]).any(axis=2), d2, np.inf)
    order = np.lexsort((np.broadcast_to(np.arange(1024), d2.shape), d2), axis=1)[:, :10]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(s.numpy(), np.take_along_axis(d2, order, axis=1))


# -- float16 and int8 corpus operands (flat storage) ---------------------------------
#
# The reference scans both in XLA: `pairwise_scores_from_norms` (float16:
# queries rounded to float16; int8: queries rounded to bf16, the sum times
# the scale) inside `block_topk`. Small integer queries and rows, and int8
# scales that are powers of two, make every product, sum and scaled sum
# exact, so distances are array-equal; another scale rounds the scaled
# sums, and the bar is ids equal and scores allclose(1e-4, 1e-4).

from comet_tpu.ops.distance import pairwise_scores_from_norms as ref_pairwise  # noqa: E402


def _lossy_data(operand, cosine, scale, seed=21):
    rng = np.random.default_rng(seed)
    if cosine:
        q = _signs(rng, 256)
        x = _signs(rng, 2048) * (64.0 if operand == "int8" else 1.0)
    else:
        q = rng.integers(0, 16, size=(256, D)).astype(np.float32)
        x = rng.integers(-15 if operand == "int8" else 0, 16, size=(2048, D)).astype(np.float32)
    valid = np.ones(2048, dtype=bool)
    valid[::7] = False
    if operand == "int8":
        xs = x.astype(np.int8)
        deq = xs.astype(np.float32) * np.float32(scale)
        sqn = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
    else:
        xs = x.astype(np.float16)
        sqn = (x * x).sum(axis=1)
    mask = np.where(valid, 0.0 if cosine else sqn, np.inf).astype(np.float32)
    return q, xs, sqn, valid, mask


def _lossy_torch(xs):
    return torch.from_numpy(xs)


@pytest.mark.parametrize("operand,scale", [("float16", None), ("int8", 0.5), ("int8", 1.0)])
@pytest.mark.parametrize("cosine", [False, True], ids=["l2", "cosine"])
def test_fused_dist_select_f16_int8_match_reference(operand, scale, cosine):
    """K2's float16 and int8 operands (their plain versions here) against
    the reference's `pairwise_scores_from_norms` with the same mask and
    threshold: dist array-equal, groups in (min, id) order."""
    if cosine and operand == "int8":
        scale = 1.0 / 64
    q, xs, sqn, valid, mask = _lossy_data(operand, cosine, scale)
    thr = FDS_THR[cosine]
    kind = RefKind.COSINE if cosine else RefKind.L2_SQUARED
    rd = np.asarray(ref_pairwise(jnp.asarray(q), jnp.asarray(xs), jnp.asarray(sqn), kind,
                                 scale=jnp.float32(scale) if scale else None))
    rd = np.where(valid[None, :] & (rd <= thr), rd, np.inf)
    dist, gsel = fused_scan.fused_dist_select(torch.from_numpy(q), _lossy_torch(xs),
                                              torch.from_numpy(mask), thr, KB, cosine,
                                              scale=scale)
    np.testing.assert_array_equal(dist.numpy(), rd)
    assert np.isinf(rd[:, ::7]).all() and np.isfinite(rd).any() and np.isinf(rd[:, 1::7]).any()
    gmin = rd.reshape(256, -1, fused_scan.GROUP).min(axis=2)
    order = np.lexsort((np.broadcast_to(np.arange(gmin.shape[1]), gmin.shape), gmin), axis=1)
    np.testing.assert_array_equal(gsel.numpy(), order[:, :KB])


def test_f16_int8_operands_check_their_inputs():
    q, xs, sqn, valid, mask = _lossy_data("int8", False, 0.5)
    args = (torch.from_numpy(q), _lossy_torch(xs), torch.from_numpy(mask), np.inf, KB)
    with pytest.raises(ValueError, match="scale"):
        fused_scan.fused_dist_select(*args)
    with pytest.raises(ValueError, match="scale"):
        fused_scan.fused_dist_select(args[0], args[1].float(), *args[2:], scale=0.5)
    with pytest.raises(ValueError, match="nprobe"):
        fused_scan.fused_dist_select(*args, scale=0.5, assign=torch.zeros(2048, dtype=torch.int32),
                                     probes=torch.zeros((256, 8), dtype=torch.int32), nlist=4)


@pytest.mark.parametrize("operand,scale", [("float16", None), ("int8", 0.5), ("int8", 0.37)])
@pytest.mark.parametrize("k,thr", [(10, 20.5), (100, np.inf)])
def test_pipeline_f16_int8_matches_reference_block_topk(operand, scale, k, thr):
    """flat_topk_pipeline over a float16 or int8 corpus (the squared
    distance selected, the threshold squared, the root at the end) against
    the reference's `block_topk` (the root inside, the threshold on it)."""
    q, xs, sqn, valid, mask = _lossy_data(operand, False, scale, seed=22)
    if operand == "float16" and thr != np.inf:
        thr = 12.5      # rows of 0..15 lie nearer than the int8 cases' -15..15
    rs, ri = ref_topk.block_topk(
        jnp.asarray(q), jnp.asarray(xs), jnp.asarray(sqn), jnp.asarray(valid),
        jnp.asarray(np.float32(thr)), k, RefKind.L2,
        scale=jnp.float32(scale) if scale else None)
    t2 = float(np.float32(thr) * np.float32(thr))
    s, i = fused_scan.flat_topk_pipeline(torch.from_numpy(q), _lossy_torch(xs),
                                         torch.from_numpy(mask), t2, k, sqrt_out=True,
                                         scale=scale)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    if scale in (None, 0.5):
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    else:
        fin = np.isfinite(np.asarray(rs))
        np.testing.assert_allclose(s.numpy()[fin], np.asarray(rs)[fin], rtol=1e-4, atol=1e-4)
    if thr != np.inf:
        assert (i.numpy() == fused_scan.IDX_SENTINEL).any()


@lru_cache(maxsize=None)
def _ref_pipe_kb_cap():
    q, x, mask = _data(256, 2048, False, seed=10)
    s, i = ref.flat_topk_pipeline(*_jax_args(q, x, mask, np.inf), 100, sqrt_out=True,
                                  kb_cap=8, interpret=True)
    return np.asarray(s), np.asarray(i)


def test_pipeline_kb_cap_matches_reference():
    """kb_cap = 8 keeps 8 of the 16 groups where k = 100 wants all: the
    reference's approximate shortlist, rank for rank (the best 8 exact,
    the rest from the kept groups)."""
    q, x, mask = _data(256, 2048, False, seed=10)
    rs, ri = _ref_pipe_kb_cap()
    s, i = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), np.inf, 100, sqrt_out=True,
                                         kb_cap=8)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(s.numpy(), rs)
    exact = fused_scan.flat_topk_pipeline(*_torch_args(q, x, mask), np.inf, 100, sqrt_out=True)
    np.testing.assert_array_equal(s.numpy()[:, :8], exact[0].numpy()[:, :8])
    assert not np.array_equal(i.numpy(), exact[1].numpy())
