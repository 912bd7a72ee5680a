"""comet_tpu_torch.ops.beam_kernel (the HNSW beam: merge step K4, in-loop
scoring, search) against comet_tpu.ops.beam_kernel on the CPU.

Inputs come from a seeded numpy generator and go to both packages. The
reference keeps the beam as [rows, Q] (queries on lanes); the port is
query-major, [Q, rows], so reference outputs are compared transposed.

- The merge step against the reference's `beam_merge_step(use_pallas=
  False)` on float data, split and fused, over ef, ew, expand and stop:
  array-equal (the merge only compares and moves values).
- The in-loop scoring, the routing tables and the entry choice on
  SIFT-range integer data, where every bf16-domain distance is exact:
  array-equal.
- Whole searches on a small graph (classic, filtered + thresholded,
  seeded, seeded with probe-starved queries): slots array-equal, scores
  allclose(1e-4) (the final re-score sums in another order than XLA's).
- The loop's exit: running exactly max_iters iterations, checking the
  flags every iteration, and the reference's early exit agree.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import beam_kernel as ref
from comet_tpu_torch.ops import beam_kernel as bk
from comet_tpu_torch.ops.distance import bf16_dot, bf16_round

SENT = 2**31 - 1
Q = 128


def make_state(rng, ef, ew, q, cap=1000):
    """A valid beam state: the beam sorted by distance with distinct slots
    and random expanded flags; candidates mixing new slots, copies of beam
    slots and copies within the batch, a slot's copies at one distance."""
    beam_d = np.full((ef, q), np.inf, np.float32)
    beam_s = np.full((ef, q), SENT, np.int32)
    beam_e = np.zeros((ef, q), np.int32)
    new_d = np.full((ew, q), np.inf, np.float32)
    new_s = np.full((ew, q), SENT, np.int32)
    for col in range(q):
        nb = rng.integers(1, ef + 1)
        slots = rng.choice(cap, size=nb, replace=False)
        beam_d[:nb, col] = np.sort(rng.random(nb).astype(np.float32) * 10)
        beam_s[:nb, col] = slots
        beam_e[:nb, col] = rng.integers(0, 2, size=nb)
        nn = rng.integers(0, ew + 1)
        pool = np.concatenate([slots, rng.choice(cap, size=ew, replace=False)])
        for j, s in enumerate(rng.choice(pool, size=nn, replace=True)):
            inbeam = np.flatnonzero(beam_s[:, col] == s)
            prev = np.flatnonzero(new_s[:j, col] == s)
            if len(inbeam):
                dv = beam_d[inbeam[0], col]
            elif len(prev):
                dv = new_d[prev[0], col]
            else:
                dv = np.float32(rng.random() * 10)
            new_d[j, col], new_s[j, col] = dv, s
    return beam_d, beam_s, beam_e, new_d, new_s


def make_results(rng, kr, q, cap=1000):
    res_d = np.full((kr, q), np.inf, np.float32)
    res_s = np.full((kr, q), SENT, np.int32)
    for col in range(q):
        nr = rng.integers(0, kr)
        res_d[:nr, col] = np.sort(rng.random(nr).astype(np.float32) * 10)
        res_s[:nr, col] = rng.choice(cap, size=nr, replace=False)
    return res_d, res_s


def _t(a):
    """[rows, Q] numpy -> query-major torch."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


def _port_step(state, ef, ew, expand, stop, fused=False, res=None, adm=None, kr=0):
    bd, bs, be, nd, ns = (_t(a) for a in state)
    extra = (_t(res[0]), _t(res[1]), _t(adm)) if fused else ()
    return bk.beam_merge_step(bd, bs, be, nd, ns, *extra, ef=ef, ew=ew, expand=expand,
                              fused=fused, kr=kr, stop=stop)


# Each (ef, ew) shape costs the reference a compile, so the shapes are few
# and (64, 64) is the whole-search tests' shape below, whose compiles they
# share; expand 23 fills every misc row. The 1M search's shape (ef = ew =
# 256, expand 8) is held against the plain version on the card
# (tests/test_torch_cuda.py, chip_smoke.py).
@pytest.mark.parametrize("ef,ew,expand,stop", [
    (32, 32, 4, None), (32, 32, 23, 8), (64, 64, 8, None), (64, 64, 4, 32),
    (16, 48, 1, 4),
])
def test_merge_step_matches_reference(ef, ew, expand, stop):
    rng = np.random.default_rng(ef * 7 + ew + expand)
    state = make_state(rng, ef, ew, Q)
    w = ref.beam_merge_step(*state, ef=ef, ew=ew, expand=expand, fused=False, stop=stop,
                            use_pallas=False)
    got = _port_step(state, ef, ew, expand, stop)
    for g, r in zip(got[:4], w[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T)
    assert got[4] is None and got[5] is None
    misc = got[3].numpy()
    assert (misc[:, expand] == 1).any() and (misc[:, :expand] >= 0).any()


@pytest.mark.parametrize("ef,ew,expand,kr,stop", [
    (32, 32, 4, 64, None), (32, 32, 8, 16, 16), (64, 64, 4, 64, 32),
])
def test_merge_step_fused_matches_reference(ef, ew, expand, kr, stop):
    rng = np.random.default_rng(kr + ef)
    state = make_state(rng, ef, ew, Q)
    res = make_results(rng, kr, Q)
    adm = rng.integers(0, 2, size=(ew, Q)).astype(np.int32)
    w = ref.beam_merge_step(*state, *res, adm, ef=ef, ew=ew, expand=expand, fused=True, kr=kr,
                            stop=stop, use_pallas=False)
    got = _port_step(state, ef, ew, expand, stop, True, res, adm, kr)
    for g, r in zip(got, w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).T)


def test_merge_step_inactive_query_is_a_fixed_point():
    """A query whose next nodes are all -1 gets only (+inf, SENT)
    candidates; a second step then leaves its beam, result set and flag
    unchanged: the reason the loop may run past the reference's exit."""
    rng = np.random.default_rng(3)
    ef, ew, expand, kr = 64, 64, 8, 128
    state = make_state(rng, ef, ew, Q)
    res = make_results(rng, kr, Q)
    adm = rng.integers(0, 2, size=(ew, Q)).astype(np.int32)
    od, osl, oe, misc, rd, rs = _port_step(state, ef, ew, expand, None, True, res, adm, kr)
    for _ in range(30):                     # run until no query is active
        if not (misc[:, expand] > 0).any():
            break
        empty = (torch.full((Q, ew), float("inf")), torch.full((Q, ew), SENT, dtype=torch.int32))
        od, osl, oe, misc, rd, rs = bk.beam_merge_step(
            od, osl, oe, *empty, rd, rs, torch.zeros((Q, ew), dtype=torch.int32),
            ef=ef, ew=ew, expand=expand, fused=True, kr=kr)
    assert not (misc[:, expand] > 0).any()
    again = bk.beam_merge_step(od, osl, oe, *empty, rd, rs, torch.zeros((Q, ew), dtype=torch.int32),
                               ef=ef, ew=ew, expand=expand, fused=True, kr=kr)
    for a, b in zip(again, (od, osl, oe, misc, rd, rs)):
        assert torch.equal(a, b)
    assert (again[3][:, :expand] == -1).all()


def test_merge_step_checks_its_inputs():
    rng = np.random.default_rng(4)
    state = make_state(rng, 16, 16, Q)
    with pytest.raises(ValueError, match="stop"):
        _port_step(state, 16, 16, 4, 17)
    with pytest.raises(ValueError, match="expand"):
        _port_step(state, 16, 16, 24, None)
    with pytest.raises(ValueError, match="new_d"):
        _port_step(state, 16, 32, 4, None)


# -- the bf16 inner product, tables, scoring -----------------------------------------


def test_bf16_dot_is_the_sequential_fma_chain():
    """Float data: bf16_dot equals a float32 sum of the exact bf16 products
    taken in ascending depth order from 0 (numpy, one element at a time)."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.normal(size=(7, 33)).astype(np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(5, 33)).astype(np.float32)).to(torch.bfloat16)
    got = bf16_dot(a[:, None, :], b[None, :, :]).numpy()
    af, bf = a.float().numpy(), b.float().numpy()
    want = np.zeros((7, 5), np.float32)
    for k in range(33):
        want = (want + af[:, None, k] * bf[None, :, k]).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def _graph(rng, n, cap, w, d):
    vectors = np.zeros((cap, d), np.float32)
    vectors[:n] = rng.integers(0, 256, size=(n, d))
    sqn = (vectors * vectors).sum(axis=1).astype(np.float32)
    adj = np.full((cap, w), -1, np.int32)
    for i in range(n):
        adj[i, 0] = (i + 1) % n
        adj[i, 1] = (i - 1) % n
        adj[i, 2:] = rng.choice(n, size=w - 2, replace=False)
    adj[5, w // 2:] = -1                      # a short row
    return vectors, sqn, adj


@pytest.mark.parametrize("cap", [512, 20000])
def test_blocked_tables_match_reference(cap):
    rng = np.random.default_rng(cap)
    vectors, sqn, adj = _graph(rng, 400, cap, 8, 16)
    adj[7, 3] = cap - 1                       # a slot needing every digit
    rv, ra = ref.build_blocked_tables(jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(sqn))
    pv, pa = bk.build_blocked_tables(torch.from_numpy(adj), torch.from_numpy(vectors),
                                     torch.from_numpy(sqn), chunk=100)
    np.testing.assert_array_equal(pv.float().numpy(), np.asarray(rv).astype(np.float32))
    np.testing.assert_array_equal(pa.float().numpy(), np.asarray(ra).astype(np.float32))
    assert bk._aux_digits(cap) == ref._aux_digits(cap) == (2 if cap == 512 else 3)


# (n, cap, W, d) of the scoring tests: the shape of the reference's tests;
# d = 100, W = 12 (vectors off 16-byte boundaries); a cap past 128^2, so
# ndig = 3, with neighbours among the last slots
SCORE_SHAPES = [(300, 512, 8, 16), (300, 512, 12, 100), (300, 20000, 8, 16)]


def _far_neighbours(rng, vectors, sqn, adj, n):
    """Point column 3 of the first n rows at the last slots of a cap past
    128^2 (every base-128 digit of slot + 1 in use), with vectors there."""
    cap, d = vectors.shape
    if cap <= 128 ** 2:
        return
    far = cap - 1 - np.arange(n) % 7
    vectors[far] = rng.integers(0, 256, size=(n, d))
    sqn[:] = (vectors * vectors).sum(axis=1)
    adj[:n, 3] = far


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,cap,w,d", SCORE_SHAPES)
def test_gather_score_matches_reference(fused, n, cap, w, d):
    rng = np.random.default_rng(11)
    e = 4
    vectors, sqn, adj = _graph(rng, n, cap, w, d)
    _far_neighbours(rng, vectors, sqn, adj, n)
    nv, aux = ref.build_blocked_tables(jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(sqn))
    q = rng.integers(0, 256, size=(Q, d)).astype(np.float32)
    nodes = rng.integers(-1, n, size=(e, Q)).astype(np.int32)
    nodes[:, 0] = -1                          # a query with nothing to expand
    nodes[0, 1] = 5                           # the short row
    qn = (q * q).sum(axis=1)
    rnd, rns, rok = ref._gather_score(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(qn), nv,
                                      aux, jnp.asarray(nodes), e * w)
    allowed = rng.random(cap) < 0.7
    thr = float(np.median(np.asarray(rnd)[np.isfinite(np.asarray(rnd))]))
    qb = torch.from_numpy(q).to(torch.bfloat16)
    bf16 = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    pnd, pns, padm = bk.gather_score(
        qb, torch.from_numpy(qn), bf16(nv), bf16(aux),
        torch.from_numpy(np.ascontiguousarray(nodes.T)), torch.from_numpy(allowed), thr, fused)
    np.testing.assert_array_equal(pnd.numpy(), np.asarray(rnd).T)
    np.testing.assert_array_equal(pns.numpy(), np.asarray(rns).T)
    assert np.isinf(pnd.numpy()[0]).all() and (pns.numpy()[0] == SENT).all()
    if fused:
        rns_t = np.asarray(rns).T
        want = (np.asarray(rok).T & allowed[np.where(rns_t == SENT, 0, rns_t)]
                & (np.asarray(rnd).T <= np.float32(thr)))
        np.testing.assert_array_equal(padm.numpy(), want.astype(np.int32))
        assert 0 < padm.numpy().sum() < want.size
    else:
        assert padm is None


def test_nearest_entry_matches_reference():
    rng = np.random.default_rng(12)
    mem = rng.integers(0, 256, size=(40, 16)).astype(np.float32)
    mem[7] = mem[3]                           # a tie: the first minimum wins
    q = rng.integers(0, 256, size=(Q, 16)).astype(np.float32)
    q[0] = mem[3]
    slots = rng.choice(1000, 40, replace=False).astype(np.int32)
    sqn = (mem * mem).sum(axis=1)
    want = ref.nearest_entry(jnp.asarray(q), jnp.asarray(mem.T).astype(jnp.bfloat16),
                             jnp.asarray(sqn), jnp.asarray(slots))
    got = bk.nearest_entry(torch.from_numpy(q), bf16_round(torch.from_numpy(mem)),
                           torch.from_numpy(sqn), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == slots[3]


# -- whole searches ------------------------------------------------------------------


N_G, CAP_G, W_G, D_G, EF, K, E = 500, 512, 16, 16, 64, 10, 4


@lru_cache(maxsize=None)
def _search_graph():
    rng = np.random.default_rng(13)
    vectors, sqn, adj = _graph(rng, N_G, CAP_G, W_G, D_G)
    queries = rng.integers(0, 256, size=(Q, D_G)).astype(np.float32)
    entry = rng.integers(0, N_G, size=Q).astype(np.int32)
    allowed = np.zeros(CAP_G, bool)
    allowed[:N_G] = rng.random(N_G) < 0.6
    return vectors, sqn, adj, queries, entry, allowed


def _seeds(starved):
    """bf16-domain seeds of every query (the exact top-20 by that distance,
    (dist, slot) order, SENT padded to 32 rows); `starved` queries get an
    empty row."""
    vectors, sqn, _, queries, _, _ = _search_graph()
    ip = queries @ vectors[:N_G].T
    bsq = bf16_round(torch.from_numpy(sqn[:N_G])).numpy()
    dist = np.maximum(((queries * queries).sum(1)[:, None] + bsq[None, :]) - 2.0 * ip, 0.0)
    order = np.lexsort((np.broadcast_to(np.arange(N_G), dist.shape), dist), axis=1)[:, :20]
    sd = np.full((Q, 32), np.inf, np.float32)
    ss = np.full((Q, 32), SENT, np.int32)
    sd[:, :20] = np.take_along_axis(dist, order, axis=1)
    ss[:, :20] = order
    sd[starved], ss[starved] = np.inf, SENT
    return sd.astype(np.float32), ss


CASES = {
    # name: (fused, threshold?, seeded, stop, starved rows)
    "classic": (False, False, False, None, ()),
    "fused-filter-threshold": (True, True, False, None, ()),
    "seeded": (False, False, True, 16, ()),
    "seeded-starved-fused": (True, False, True, 32, (0, 5, 77)),
}


def _threshold():
    vectors, _, _, queries, _, _ = _search_graph()
    d = ((queries[:, None, :] - vectors[None, :N_G]) ** 2).sum(-1)
    return float(np.median(np.sort(d, axis=1)[:, 5]))


@lru_cache(maxsize=None)
def _ref_search(case):
    fused, thr, seeded, stop, starved = CASES[case]
    vectors, sqn, adj, queries, entry, allowed = _search_graph()
    nv, aux = ref.build_blocked_tables(jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(sqn))
    seeds = tuple(jnp.asarray(a) for a in _seeds(list(starved))) if seeded else None
    allow = allowed if fused else np.ones(CAP_G, bool)
    sd, ss = ref.beam_search_blocked(
        queries, entry, nv, aux, vectors, sqn, allow,
        np.float32(_threshold() if thr else np.inf), ef=EF, k=K, expand=E, max_iters=48,
        fused=fused, use_pallas=False, seeds=seeds, stop=stop)
    return np.asarray(sd), np.asarray(ss)


def _port_search(case):
    fused, thr, seeded, stop, starved = CASES[case]
    vectors, sqn, adj, queries, entry, allowed = _search_graph()
    t = torch.from_numpy
    nv, aux = bk.build_blocked_tables(t(adj), t(vectors), t(sqn))
    seeds = tuple(t(a) for a in _seeds(list(starved))) if seeded else None
    allow = allowed if fused else np.ones(CAP_G, bool)
    sd, ss = bk.beam_search_blocked(
        t(queries), t(entry), nv, aux, t(vectors), t(sqn), t(allow),
        float(np.float32(_threshold())) if thr else float("inf"), EF, K, E, 48, fused,
        seeds=seeds, stop=stop)
    return sd.numpy(), ss.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_reference(case):
    rd, rs = _ref_search(case)
    pd, ps = _port_search(case)
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1e-4)
    assert (ps[:, 0] != SENT).all() or case == "fused-filter-threshold"
    if CASES[case][0]:
        _, _, _, _, _, allowed = _search_graph()
        hits = ps[ps != SENT]
        assert len(hits) and allowed[hits].all()


@pytest.mark.parametrize("every", [1, 1000])
def test_loop_exit_matches_early_exit(every, monkeypatch):
    """Checking the flags every iteration, or never (so exactly max_iters
    iterations run), returns the reference's early-exit results."""
    monkeypatch.setattr(bk, "ALIVE_EVERY", every)
    calls = []
    real = bk.gather_score
    monkeypatch.setattr(bk, "gather_score", lambda *a: calls.append(1) or real(*a))
    rd, rs = _ref_search("classic")
    pd, ps = _port_search("classic")
    np.testing.assert_array_equal(ps, rs)
    np.testing.assert_allclose(pd, rd, rtol=1e-4, atol=1e-4)
    assert (len(calls) == 48) == (every == 1000)


# -- the packed table and K5 -----------------------------------------------------------


def _bits16(t):
    """bf16 tensor / array -> its raw 16 bits as int64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    return np.asarray(t).view(np.uint16).astype(np.int64)


@pytest.mark.parametrize("cap", [512, 20000])
def test_packed_table_and_row_updates_match_reference(cap):
    """build_packed_table, update_packed_rows and update_blocked_rows give
    the reference's bf16 bits (Gaussian data: the bf16 rounding is part of
    the comparison)."""
    rng = np.random.default_rng(cap + 1)
    n, w, d = 400, 8, 16
    vectors = np.zeros((cap, d), np.float32)
    vectors[:n] = rng.normal(size=(n, d))
    sqn = (vectors * vectors).sum(axis=1).astype(np.float32)
    adj = rng.integers(-1, n, size=(cap, w)).astype(np.int32)
    adj[7, 3] = cap - 1
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = torch.from_numpy
    rp = ref.build_packed_table(j(adj), j(vectors), j(sqn))
    pp = bk.build_packed_table(t(adj), t(vectors), t(sqn), chunk=100)
    np.testing.assert_array_equal(_bits16(pp), _bits16(rp))
    assert pp.shape == (cap, w * d + (1 + bk._aux_digits(cap)) * w)
    assert bk._table_width(pp, d) == ref._table_width(rp, d) == w
    rows = np.array([3, 17, 64, 101], np.int64)
    adj2 = adj.copy()
    adj2[rows] = rng.integers(-1, n, size=(len(rows), w))
    rp2 = ref.update_packed_rows(rp, j(rows), j(adj2[rows]), j(vectors), j(sqn))
    pp2 = bk.update_packed_rows(pp, t(rows), t(adj2[rows]), t(vectors), t(sqn))
    np.testing.assert_array_equal(_bits16(pp2), _bits16(rp2))
    np.testing.assert_array_equal(_bits16(pp2), _bits16(bk.build_packed_table(
        t(adj2), t(vectors), t(sqn))))
    rv, ra = ref.build_blocked_tables(j(adj), j(vectors), j(sqn))
    rv2, ra2 = ref.update_blocked_rows(rv, ra, j(rows), j(adj2[rows]), j(vectors), j(sqn))
    pv, pa = bk.build_blocked_tables(t(adj), t(vectors), t(sqn))
    pv2, pa2 = bk.update_blocked_rows(pv, pa, t(rows), t(adj2[rows]), t(vectors), t(sqn))
    np.testing.assert_array_equal(_bits16(pv2), _bits16(rv2))
    np.testing.assert_array_equal(_bits16(pa2), _bits16(ra2))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,cap,w,d", [(300, 512, 4, 16)] + SCORE_SHAPES[1:])
def test_gather_score_packed_matches_blocked_and_reference(fused, n, cap, w, d):
    """The packed layout scores bit-equal to the blocked one and to the
    reference's packed `_gather_score`; W = 4, d = 16, cap 512 makes rows
    of 152 bytes, most of them off a 16-byte boundary (W = 12, d = 100:
    2472 bytes)."""
    rng = np.random.default_rng(14)
    e = 4
    vectors, sqn, adj = _graph(rng, n, cap, w, d)
    _far_neighbours(rng, vectors, sqn, adj, n)
    t = torch.from_numpy
    packed = bk.build_packed_table(t(adj), t(vectors), t(sqn))
    nv, aux = bk.build_blocked_tables(t(adj), t(vectors), t(sqn))
    q = rng.integers(0, 256, size=(Q, d)).astype(np.float32)
    nodes = rng.integers(-1, n, size=(Q, e)).astype(np.int32)
    nodes[0] = -1                             # a query with nothing to expand
    qn = (q * q).sum(axis=1)
    qb = t(q).to(torch.bfloat16)
    allowed = t(rng.random(cap) < 0.7)
    got = bk.gather_score(qb, t(qn), packed, None, t(nodes), allowed, 3e5, fused)
    want = bk.gather_score(qb, t(qn), nv, aux, t(nodes), allowed, 3e5, fused)
    for g, wv in zip(got, want):
        assert (g is None) == (wv is None)
        if g is not None:
            assert torch.equal(g, wv)
    rpk = ref.build_packed_table(jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(sqn))
    rnd, rns, _ = ref._gather_score(jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(qn), rpk,
                                    None, jnp.asarray(nodes.T), e * w)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(rnd).T)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(rns).T)
    assert np.isinf(got[0].numpy()[0]).all() and np.isfinite(got[0].numpy()).any()
    assert (got[1].numpy()[0] == SENT).all()


def _fuse_case():
    """The reference test's shape (tests/test_beam_kernel.py): cap 512,
    d 16, W 4, E 4, ef 32, 128 queries; small integers, holes in the
    adjacency and finished queries."""
    rng = np.random.default_rng(15)
    cap, d, w, e, ef = 512, 16, 4, 4, 32
    vectors = rng.integers(-2, 3, size=(cap, d)).astype(np.float32)
    sqn = (vectors * vectors).sum(axis=1).astype(np.float32)
    adj = rng.integers(0, cap, size=(cap, w)).astype(np.int32)
    adj[rng.random(size=adj.shape) < 0.2] = -1
    queries = rng.integers(-2, 3, size=(Q, d)).astype(np.float32)
    nodes = rng.integers(0, cap, size=(e, Q)).astype(np.int32)
    nodes[rng.random(size=nodes.shape) < 0.15] = -1
    beam = make_state(rng, ef, e * w, Q, cap=cap)[:3]
    return vectors, sqn, adj, queries, nodes, beam, ef, e


@lru_cache(maxsize=None)
def _ref_fused_expand(stop):
    vectors, sqn, adj, queries, nodes, beam, ef, e = _fuse_case()
    packed = ref.build_packed_table(jnp.asarray(adj), jnp.asarray(vectors), jnp.asarray(sqn))
    rows = packed[jnp.maximum(jnp.asarray(nodes), 0)]
    qb = jnp.asarray(queries).astype(jnp.bfloat16)
    qn = jnp.asarray((queries * queries).sum(axis=1))
    out = ref.fused_expand_merge(
        jnp.asarray(nodes), rows, qb, qn, *(jnp.asarray(a) for a in beam), ef=ef, W=adj.shape[1],
        d=vectors.shape[1], ndig=ref._aux_digits(len(adj)), expand=e, stop=stop, interpret=True)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("stop", [None, 16])
def test_fused_expand_merge_matches_reference(stop):
    """K5's plain version (the CPU path of fused_expand_merge) against the
    reference's Pallas kernel in interpret mode, and against the port's
    split pair."""
    vectors, sqn, adj, queries, nodes, beam, ef, e = _fuse_case()
    t = torch.from_numpy
    packed = bk.build_packed_table(t(adj), t(vectors), t(sqn))
    qb = t(queries).to(torch.bfloat16)
    qn = t((queries * queries).sum(axis=1))
    bd, bs, be = (_t(a) for a in beam)
    nt = _t(nodes)
    got = bk.fused_expand_merge(nt, packed, qb, qn, bd, bs, be, ef=ef, expand=e, stop=stop)
    for g, r in zip(got, _ref_fused_expand(stop)):
        np.testing.assert_array_equal(g.numpy(), r.T)
    nd, ns, _ = bk.gather_score(qb, qn, packed, None, nt, None, np.inf, False)
    split = bk.beam_merge_step(bd, bs, be, nd, ns, ef=ef, ew=e * adj.shape[1], expand=e,
                               fused=False, stop=stop)
    for g, sv in zip(got, split):
        assert torch.equal(g, sv)


def _port_search_layout(case, layout):
    fused, thr, seeded, stop, starved = CASES[case]
    vectors, sqn, adj, queries, entry, allowed = _search_graph()
    t = torch.from_numpy
    if layout == "blocked":
        nv, aux = bk.build_blocked_tables(t(adj), t(vectors), t(sqn))
    else:
        nv, aux = bk.build_packed_table(t(adj), t(vectors), t(sqn)), None
    seeds = tuple(t(a) for a in _seeds(list(starved))) if seeded else None
    allow = allowed if fused else np.ones(CAP_G, bool)
    sd, ss = bk.beam_search_blocked(
        t(queries), t(entry), nv, aux, t(vectors), t(sqn), t(allow),
        float(np.float32(_threshold())) if thr else float("inf"), EF, K, E, 48, fused,
        seeds=seeds, stop=stop, fuse=layout == "fused")
    return sd.numpy(), ss.numpy()


@pytest.mark.parametrize("layout", ["packed", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_search_layouts_match_blocked(case, layout, monkeypatch):
    """Whole searches over the packed table, split or with K5 (which the
    result-set cases leave to the split path, as the reference does),
    array-equal to the blocked search and to the reference."""
    calls = []
    real = bk.fused_expand_merge
    monkeypatch.setattr(bk, "fused_expand_merge", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pd, ps = _port_search_layout(case, layout)
    bd, bs = _port_search_layout(case, "blocked")
    np.testing.assert_array_equal(ps, bs)
    np.testing.assert_array_equal(pd, bd)
    rd, rs = _ref_search(case)
    np.testing.assert_array_equal(ps, rs)
    assert bool(calls) == (layout == "fused" and not CASES[case][0])
