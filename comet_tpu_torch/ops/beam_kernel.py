"""HNSW layer-0 beam search over neighbourhood routing tables: the merge
step (kernel K4), the in-loop scoring around it, and the fused expand
kernel (K5) that does both in one launch.

Counterpart of comet_tpu/ops/beam_kernel.py, search half. The beam of every
query lives in query-major tensors ([Q, rows]; the reference keeps [rows,
Q], queries on lanes). A node's routing row holds its W neighbour vectors
in bf16 and its aux row (bf16 squared norms and the base-128 digits of the
neighbour slots), in one of two layouts:

- blocked (`build_blocked_tables`): nbr_vecs [cap, W, d] and aux [cap,
  (1 + ndig) W], two tables;
- packed (`build_packed_table`): one [cap, W d + (1 + ndig) W] table, the
  vectors and the aux planes of a node in one row; `aux` is None.

One iteration of the split path:

  1. `gather_score`: the `expand` nodes picked last step are expanded: each
     node's row is scored against the bf16 query, giving ew = expand * W
     candidates (dist, slot) and, in fused mode, their admission flags. On
     a CUDA tensor the kernel of csrc/gather_score.cu does it, for either
     layout (`SCORE_LAUNCHES` blocked, `PACKED_SCORE_LAUNCHES` packed), on
     a CPU tensor `_gather_score_plain`.
  2. `beam_merge_step` (K4): beam + candidates sorted by (dist, slot,
     expanded desc), adjacent copies of a slot killed, the live rows
     compacted to the distinct top-ef, the next `expand` unexpanded rows
     picked with the query's active flag; in fused mode the admitted
     candidates also join a result set of kr rows. On a CUDA tensor
     csrc/beam_merge.cu (`LAUNCHES` split, `FUSED_LAUNCHES` fused), which
     sorts only the candidates and merges them with the sorted beam; on a
     CPU tensor `_merge_plain`.

With `fuse` (COMET_HNSW_FUSE=1), an unfiltered search over the packed
table runs both steps as one launch of K5, `fused_expand_merge`
(csrc/fused_expand.cu, `FUSE_LAUNCHES`; on a CPU tensor
`_fused_expand_plain`), which reads the expanded rows from the table
itself. Its outputs are the split pair's bit for bit.

Copies of a node sort adjacent only if their distances are bit-equal: the
seed scan (ops/ivf_sparse, bf16 mode), the probe-starved entry start and
the in-loop scoring (split or fused) all compute the inner product as
`bf16_dot` (ops/distance.py), the FMA chain of the kernels.

The loop needs no per-iteration sync. Once a query is inactive its next
nodes are all -1, so its candidates are all (+inf, SENT) and not admitted;
sort, kill, compaction and select then leave its beam, its result set and
its flag as they were. Running more iterations than the reference's
early-exit loop (which stops when no query is active) therefore changes
nothing: `beam_search_blocked` reads the flags only every `ALIVE_EVERY`
iterations and stops at the first check that finds none active, or at
max_iters, with the reference's results bit for bit
(tests/test_torch_beam_kernel.py holds it to a run of exactly max_iters).

Distances inside the loop are squared L2 in the bf16 domain (cosine rides
the same path on normalised vectors); `_search_finalize` re-scores the top
candidates exactly in float32 before the final (score, slot) order.
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.distance import bf16_dot, bf16_round, f32_matmul
from comet_tpu_torch.ops.sortnet import topk_rows, use_plain
from comet_tpu_torch.ops.topk import IDX_SENTINEL, dist_key_bits, lexsort_topk

SENT = IDX_SENTINEL
INF = float("inf")
MISC_ROWS = 24       # next-node slots (<= 23) + the active flag
# 64-bit sort keys of empty rows: (+inf, SENT, not expanded), (+inf, SENT)
BEAM_PAD = (0x7F800000 << 32) | (SENT << 1) | 1
RES_PAD = (0x7F800000 << 32) | SENT
ALIVE_EVERY = 4      # iterations between reads of the active flags

# Kernel launches: K4 split mode, K4 fused mode, the in-loop scoring over
# the blocked and over the packed layout, K5.
LAUNCHES = 0
FUSED_LAUNCHES = 0
SCORE_LAUNCHES = 0
PACKED_SCORE_LAUNCHES = 0
FUSE_LAUNCHES = 0


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


# -- routing tables ----------------------------------------------------------------


def _aux_digits(cap: int) -> int:
    """Base-128 digits needed to hold slot + 1 for a cap-row table (each
    digit, an integer 0..127, is exact in bfloat16)."""
    ndig = 1
    while (128 ** ndig) <= cap:
        ndig += 1
    return ndig


def _aux_planes(adj_rows: torch.Tensor, nsq: torch.Tensor, cap: int) -> torch.Tensor:
    """One bf16 aux row per node: [sqnorms | base-128 digit planes of
    slot + 1], [R, (1 + ndig) W]; -1 padding encodes as 0."""
    a1 = adj_rows + 1
    planes = [nsq.to(torch.bfloat16)]
    for i in range(_aux_digits(cap)):
        planes.append(((a1 >> (7 * i)) & 127).to(torch.bfloat16))
    return torch.cat(planes, dim=1)


def _table_width(nbr_vecs: torch.Tensor, d: int) -> int:
    """Neighbourhood width W of either layout: blocked [cap, W, d] or
    packed [cap, W (d + 1 + ndig)]."""
    if nbr_vecs.ndim == 3 and nbr_vecs.shape[2] == d:
        return nbr_vecs.shape[1]
    if nbr_vecs.ndim == 2:
        cap, row_len = nbr_vecs.shape
        per = d + 1 + _aux_digits(cap)
        if row_len % per == 0 and row_len > 0:
            return row_len // per
    raise ValueError(f"nbr_vecs must be [cap, W, {d}] or [cap, W ({d} + 1 + ndig)], "
                     f"got {tuple(nbr_vecs.shape)}")


def _neighbour_rows(adj_rows: torch.Tensor, vectors: torch.Tensor, sqnorms: torch.Tensor,
                    cap: int):
    """The routing rows of adjacency rows [R, W]: (bf16 neighbour vectors
    [R, W, d], aux rows [R, (1 + ndig) W]) for a cap-row table."""
    nc = adj_rows.clamp_min(0).long()
    nsq = torch.where(adj_rows >= 0, sqnorms[nc], torch.zeros((), device=vectors.device))
    return vectors[nc].to(torch.bfloat16), _aux_planes(adj_rows, nsq, cap)


def build_blocked_tables(adj: torch.Tensor, vectors: torch.Tensor, sqnorms: torch.Tensor,
                         chunk: int = 1 << 16):
    """The neighbourhood-blocked routing tables of a layer-0 adjacency
    [cap, W] (-1 padded): nbr_vecs [cap, W, d] bf16 with nbr_vecs[p, j] =
    vectors[adj[p, j]], and the aux rows (`_aux_planes`). Built in row
    chunks: the whole float32 gather would be twice the table."""
    cap, w = adj.shape
    d = vectors.shape[1]
    nbr_vecs = torch.empty((cap, w, d), dtype=torch.bfloat16, device=vectors.device)
    aux = torch.empty((cap, (1 + _aux_digits(cap)) * w), dtype=torch.bfloat16,
                      device=vectors.device)
    for lo in range(0, cap, chunk):
        nbr_vecs[lo:lo + chunk], aux[lo:lo + chunk] = _neighbour_rows(
            adj[lo:lo + chunk], vectors, sqnorms, cap)
    return nbr_vecs, aux


def update_blocked_rows(nbr_vecs, aux, rows, adj_rows, vectors, sqnorms):
    """Rewrite the blocked rows `rows` [R] (int64) from their adjacency rows
    [R, W] after an insertion round, in place. Returns (nbr_vecs, aux)."""
    nbr_vecs[rows], aux[rows] = _neighbour_rows(adj_rows, vectors, sqnorms, nbr_vecs.shape[0])
    return nbr_vecs, aux


def _packed_rows(adj_rows, vectors, sqnorms, cap: int) -> torch.Tensor:
    nv, ar = _neighbour_rows(adj_rows, vectors, sqnorms, cap)
    return torch.cat([nv.reshape(nv.shape[0], -1), ar], dim=1)


def build_packed_table(adj: torch.Tensor, vectors: torch.Tensor, sqnorms: torch.Tensor,
                       chunk: int = 1 << 16) -> torch.Tensor:
    """The packed routing table: one bf16 row per node holding its W
    neighbour vectors and its aux planes, [cap, W d + (1 + ndig) W]; its
    scored outputs are the blocked pair's bit for bit. Built in row chunks
    (reference build_packed_table_chunked: the one-shot gather is twice the
    table)."""
    cap, w = adj.shape
    d = vectors.shape[1]
    packed = torch.empty((cap, w * d + (1 + _aux_digits(cap)) * w), dtype=torch.bfloat16,
                         device=vectors.device)
    for lo in range(0, cap, chunk):
        packed[lo:lo + chunk] = _packed_rows(adj[lo:lo + chunk], vectors, sqnorms, cap)
    return packed


def update_packed_rows(packed, rows, adj_rows, vectors, sqnorms) -> torch.Tensor:
    """Rewrite the packed rows `rows` [R] (int64) from their adjacency rows
    [R, W], in place. Returns the table."""
    packed[rows] = _packed_rows(adj_rows, vectors, sqnorms, packed.shape[0])
    return packed


# -- in-loop scoring ---------------------------------------------------------------


def _gather_rows(nbr_vecs, aux, nc, d: int):
    """The routing rows of nodes nc [...]: (vectors [..., W, d] bf16, aux
    rows [..., (1 + ndig) W] float32), from either layout."""
    w = _table_width(nbr_vecs, d)
    if aux is None:
        rows = nbr_vecs[nc]
        return rows[..., :w * d].unflatten(-1, (w, d)), rows[..., w * d:].to(torch.float32)
    return nbr_vecs[nc], aux[nc].to(torch.float32)


def _gather_score_plain(qb, qn, nbr_vecs, aux, nodes, allowed, thr: float, fused: bool):
    """Plain PyTorch version of csrc/gather_score.cu, either layout.
    Returns (nd [Q, ew] float32, ns [Q, ew] int32, adm [Q, ew] int32 or
    None)."""
    q_n, e_n = nodes.shape
    node_ok = nodes >= 0
    nc = nodes.clamp_min(0).long()
    nv, ar = _gather_rows(nbr_vecs, aux, nc, qb.shape[1])   # [Q, E, W, d], [Q, E, (1 + ndig) W]
    w = nv.shape[2]
    ndig = ar.shape[-1] // w - 1
    nsq = ar[..., :w]
    a1 = ar[..., w:2 * w]
    for i in range(1, ndig):
        a1 = a1 + ar[..., (i + 1) * w:(i + 2) * w] * float(128 ** i)
    neigh = a1.to(torch.int32) - 1                        # [Q, E, W]
    ok = node_ok[:, :, None] & (neigh >= 0)
    ip = bf16_dot(qb[:, None, None, :], nv)               # [Q, E, W]
    nd = torch.clamp_min((qn[:, None, None] + nsq) - 2.0 * ip, 0.0)
    nd = torch.where(ok, nd, torch.full_like(nd, INF)).reshape(q_n, e_n * w)
    ns = torch.where(ok, neigh, torch.full_like(neigh, SENT)).reshape(q_n, e_n * w)
    if not fused:
        return nd, ns, None
    okf = ok.reshape(q_n, e_n * w)
    adm = okf & allowed[torch.where(okf, ns, torch.zeros_like(ns)).long()] & (nd <= thr)
    return nd, ns, adm.to(torch.int32)


def _row_pointers(nbr_vecs, aux, d: int):
    """(W, ndig, vectors pointer, aux pointer, vector row stride, aux row
    stride) of either layout, strides in elements, for the kernels."""
    w = _table_width(nbr_vecs, d)
    if aux is None:
        row_len = nbr_vecs.shape[1]
        base = nbr_vecs.data_ptr()
        return (w, row_len // w - d - 1, base, base + 2 * w * d, row_len, row_len)
    return (w, aux.shape[1] // w - 1, nbr_vecs.data_ptr(), aux.data_ptr(), w * d,
            aux.shape[1])


def _gather_score_cuda(qb, qn, nbr_vecs, aux, nodes, allowed, thr: float, fused: bool):
    """Launch csrc/gather_score.cu. Returns (nd, ns, adm or None), [Q, ew]."""
    global SCORE_LAUNCHES, PACKED_SCORE_LAUNCHES
    lib = _build.library()
    q_n, e_n = nodes.shape
    d = qb.shape[1]
    w, ndig, vp, ap, vs, as_ = _row_pointers(nbr_vecs, aux, d)
    dev = qb.device
    nd = torch.empty((q_n, e_n * w), dtype=torch.float32, device=dev)
    ns = torch.empty((q_n, e_n * w), dtype=torch.int32, device=dev)
    adm = torch.empty((q_n, e_n * w), dtype=torch.int32, device=dev) if fused else None
    code = lib.comet_gather_score(
        qb.data_ptr(), qn.data_ptr(), vp, ap, vs, as_, nodes.data_ptr(),
        allowed.data_ptr() if fused else None, thr, q_n, e_n, w, d, ndig, int(fused),
        nd.data_ptr(), ns.data_ptr(), adm.data_ptr() if fused else None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    with _build.COUNT_LOCK:
        if aux is None:
            PACKED_SCORE_LAUNCHES += 1
        else:
            SCORE_LAUNCHES += 1
    _build.check(code, "gather_score")
    return nd, ns, adm


def _check_tables(qb, nbr_vecs, aux, nodes):
    if not qb.dtype == nbr_vecs.dtype == torch.bfloat16 or (
            aux is not None and aux.dtype != torch.bfloat16):
        raise ValueError("qb, nbr_vecs and aux must be bfloat16")
    if nodes.dtype != torch.int32 or nodes.ndim != 2 or nodes.shape[0] != qb.shape[0]:
        raise ValueError(f"nodes must be int32 [{qb.shape[0]}, E], got {nodes.dtype} "
                         f"{tuple(nodes.shape)}")
    if (aux is None and nbr_vecs.ndim != 2) or (aux is not None and nbr_vecs.ndim != 3):
        raise ValueError("aux goes with the blocked table [cap, W, d], None with the packed one")
    _table_width(nbr_vecs, qb.shape[1])


def gather_score(qb, qn, nbr_vecs, aux, nodes, allowed, thr: float, fused: bool):
    """Score the neighbourhoods of `nodes` [Q, E] (-1 = none) against the
    bf16 queries qb [Q, d] (norms qn [Q] float32, of the float32 queries),
    over the blocked tables (nbr_vecs, aux) or the packed table (nbr_vecs,
    aux=None). Returns (nd [Q, E W] float32, ns [Q, E W] int32, adm [Q,
    E W] int32 admission flags, or None unless `fused`)."""
    _check_tables(qb, nbr_vecs, aux, nodes)
    thr = float(thr)
    args = (qb.contiguous(), qn.contiguous(), nbr_vecs.contiguous(),
            aux.contiguous() if aux is not None else None, nodes.contiguous(),
            allowed.contiguous() if fused else None, thr, fused)
    if use_plain(qb):
        return _gather_score_plain(*args)
    return _gather_score_cuda(*args)


# -- the merge step: K4 and its plain version ------------------------------------------


def _bits_dist(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def _kill_compact(keys: torch.Tensor, slot: torch.Tensor, width: int, pad: int):
    """Kill rows whose slot is SENT or the previous row's, compact the
    live rows in order and cut to `width` columns, filled with `pad`."""
    dead = slot == SENT
    dead[:, 1:] |= slot[:, 1:] == slot[:, :-1]
    order = torch.sort(dead.to(torch.int8), dim=1, stable=True).indices
    keys = torch.where(dead.gather(1, order), torch.full_like(keys, pad), keys.gather(1, order))
    if keys.shape[1] < width:
        keys = torch.cat([keys, keys.new_full((keys.shape[0], width - keys.shape[1]), pad)], dim=1)
    return keys[:, :width]


def _merge_plain(bd, bs, be, nd, ns, rd, rs, adm, ef, ew, expand, fused, kr, stop):
    """Plain PyTorch version of K4, the phases of the reference's
    _merge_body on query-major tensors."""
    q_n = bd.shape[0]
    # 1. one 64-bit key per row: (dist bits, slot, 1 - expanded)
    d = torch.cat([bd, nd], dim=1)
    s = torch.cat([bs, ns], dim=1).to(torch.int64)
    e = torch.cat([be, torch.zeros_like(ns)], dim=1).to(torch.int64)
    keys = torch.sort((dist_key_bits(d) << 32) | (s << 1) | (1 - e), dim=1).values
    # 2-3. kill the copies, compact, keep the first ef rows
    keys = _kill_compact(keys, (keys >> 1) & 0x7FFFFFFF, ef, BEAM_PAD)
    od = _bits_dist(keys >> 32)
    osl = ((keys >> 1) & 0x7FFFFFFF).to(torch.int32)
    oe = (1 - (keys & 1)).to(torch.int32)
    # 4. the first `expand` unexpanded rows and the active flag
    unexp = (oe == 0) & (osl != SENT)
    ud = torch.where(unexp, od, torch.full_like(od, INF))
    d_first = ud.min(dim=1).values
    active = (d_first < INF) & (d_first <= od[:, stop - 1])
    rank = torch.cumsum(unexp.to(torch.int32), dim=1)
    sel = unexp & (rank <= expand) & active[:, None]
    oe = oe | sel.to(torch.int32)
    misc = torch.full((q_n, MISC_ROWS), -1, dtype=torch.int32, device=bd.device)
    slot1 = osl.to(torch.int64) + 1
    for j in range(expand):
        pick = sel & (rank == j + 1)
        misc[:, j] = (torch.where(pick, slot1, 0).sum(dim=1) - 1).to(torch.int32)
    misc[:, expand] = active.to(torch.int32)
    if not fused:
        return od, osl, oe, misc, None, None
    # 5. the result set
    a = adm != 0
    rdall = torch.cat([rd, torch.where(a, nd, torch.full_like(nd, INF))], dim=1)
    rsall = torch.cat([rs, torch.where(a, ns, torch.full_like(ns, SENT))], dim=1).to(torch.int64)
    rkeys = torch.sort((dist_key_bits(rdall) << 32) | rsall, dim=1).values
    rkeys = _kill_compact(rkeys, rkeys & 0x7FFFFFFF, kr, RES_PAD)
    return (od, osl, oe, misc, _bits_dist(rkeys >> 32),
            (rkeys & 0x7FFFFFFF).to(torch.int32))


def _merge_cuda(bd, bs, be, nd, ns, rd, rs, adm, ef, ew, expand, fused, kr, stop):
    """Launch K4 (csrc/beam_merge.cu)."""
    global LAUNCHES, FUSED_LAUNCHES
    lib = _build.library()
    q_n = bd.shape[0]
    dev = bd.device
    od = torch.empty((q_n, ef), dtype=torch.float32, device=dev)
    osl = torch.empty((q_n, ef), dtype=torch.int32, device=dev)
    oe = torch.empty((q_n, ef), dtype=torch.int32, device=dev)
    misc = torch.empty((q_n, MISC_ROWS), dtype=torch.int32, device=dev)
    ord_ = ors = None
    if fused:
        ord_ = torch.empty((q_n, kr), dtype=torch.float32, device=dev)
        ors = torch.empty((q_n, kr), dtype=torch.int32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = lib.comet_beam_merge(
        ptr(bd), ptr(bs), ptr(be), ptr(nd), ptr(ns), ptr(rd), ptr(rs), ptr(adm),
        q_n, ef, ew, expand, stop, kr, int(fused),
        ptr(od), ptr(osl), ptr(oe), ptr(misc), ptr(ord_), ptr(ors),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    with _build.COUNT_LOCK:
        if fused:
            FUSED_LAUNCHES += 1
        else:
            LAUNCHES += 1
    _build.check(code, "beam_merge")
    return od, osl, oe, misc, ord_, ors


def beam_merge_step(
    beam_d, beam_s, beam_e,     # [Q, ef] float32, int32, int32 (0/1)
    new_d, new_s,               # [Q, ew] float32, int32
    res_d=None, res_s=None,     # [Q, kr] (fused only)
    adm=None,                   # [Q, ew] int32 0/1 (fused only)
    *, ef: int, ew: int, expand: int, fused: bool, kr: int = 0, stop: int | None = None,
):
    """One merge / dedup / compact / select step (module docstring).

    The beam arrives sorted by (dist, slot, expanded desc), and the result
    set by (dist, slot), as the previous step left them; the kernel merges
    them as sorted runs and sorts either one first only when it does not
    ascend, so any input gives `_merge_plain`'s result. Returns
    (beam_d', beam_s', beam_e', misc [Q, MISC_ROWS], res_d', res_s'):
    misc[:, :expand] are the next nodes (-1 none), misc[:, expand] the
    active flag, the rest -1; res_d', res_s' are None unless `fused`."""
    if stop is None:
        stop = ef
    q_n = beam_d.shape[0]
    if not 1 <= expand < MISC_ROWS:
        raise ValueError(f"expand={expand} outside [1, {MISC_ROWS})")
    if not 1 <= stop <= ef:
        raise ValueError(f"stop={stop} outside [1, {ef}]")
    shapes = [("beam_d", beam_d, (q_n, ef), torch.float32),
              ("beam_s", beam_s, (q_n, ef), torch.int32),
              ("beam_e", beam_e, (q_n, ef), torch.int32),
              ("new_d", new_d, (q_n, ew), torch.float32),
              ("new_s", new_s, (q_n, ew), torch.int32)]
    if fused:
        if kr < 1:
            raise ValueError("the fused mode needs kr >= 1")
        shapes += [("res_d", res_d, (q_n, kr), torch.float32),
                   ("res_s", res_s, (q_n, kr), torch.int32),
                   ("adm", adm, (q_n, ew), torch.int32)]
    for name, t, shape, dt in shapes:
        if t is None or tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {dt} {shape}, got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
        if t.device != beam_d.device:
            raise ValueError(f"{name} is on {t.device}, beam_d on {beam_d.device}")
    args = [t.contiguous() if t is not None else None
            for t in (beam_d, beam_s, beam_e, new_d, new_s,
                      res_d if fused else None, res_s if fused else None, adm if fused else None)]
    if use_plain(beam_d):
        return _merge_plain(*args, ef, ew, expand, fused, kr, stop)
    return _merge_cuda(*args, ef, ew, expand, fused, kr, stop)


# -- K5: expand, score and merge in one launch ------------------------------------------


def _fused_expand_plain(nodes, packed, qb, qn, bd, bs, be, ef, expand, stop):
    """Plain PyTorch version of K5: the split pair's plain versions, the
    packed-table scoring then the split merge."""
    w = _table_width(packed, qb.shape[1])
    nd, ns, _ = _gather_score_plain(qb, qn, packed, None, nodes, None, INF, False)
    od, osl, oe, misc, _, _ = _merge_plain(bd, bs, be, nd, ns, None, None, None, ef,
                                           expand * w, expand, False, 0, stop)
    return od, osl, oe, misc


def _fused_expand_cuda(nodes, packed, qb, qn, bd, bs, be, ef, expand, stop):
    """Launch K5 (csrc/fused_expand.cu)."""
    global FUSE_LAUNCHES
    lib = _build.library()
    q_n, d = qb.shape
    w = _table_width(packed, d)
    row_len = packed.shape[1]
    dev = qb.device
    od = torch.empty((q_n, ef), dtype=torch.float32, device=dev)
    osl = torch.empty((q_n, ef), dtype=torch.int32, device=dev)
    oe = torch.empty((q_n, ef), dtype=torch.int32, device=dev)
    misc = torch.empty((q_n, MISC_ROWS), dtype=torch.int32, device=dev)
    code = lib.comet_fused_expand(
        nodes.data_ptr(), packed.data_ptr(), row_len, qb.data_ptr(), qn.data_ptr(),
        bd.data_ptr(), bs.data_ptr(), be.data_ptr(), q_n, ef, w, d, row_len // w - d - 1,
        expand, stop, od.data_ptr(), osl.data_ptr(), oe.data_ptr(), misc.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    with _build.COUNT_LOCK:
        FUSE_LAUNCHES += 1
    _build.check(code, "fused_expand")
    return od, osl, oe, misc


def fused_expand_merge(nodes, packed, qb, qn, beam_d, beam_s, beam_e, *, ef: int,
                       expand: int, stop: int | None = None):
    """One iteration of an unfiltered search over the packed table in one
    step (reference fused_expand_merge, which takes the rows gathered
    beforehand; this one reads them from the table): score the
    neighbourhoods of `nodes` [Q, expand] (-1 = none) against qb [Q, d]
    bf16 (norms qn [Q]), then the split merge of beam_merge_step. Returns
    (beam_d', beam_s', beam_e', misc), bit-equal to gather_score followed
    by beam_merge_step(fused=False)."""
    if stop is None:
        stop = ef
    _check_tables(qb, packed, None, nodes)
    q_n = qb.shape[0]
    if nodes.shape[1] != expand or not 1 <= expand < MISC_ROWS:
        raise ValueError(f"nodes must be [{q_n}, expand] with 1 <= expand < {MISC_ROWS}, "
                         f"got {tuple(nodes.shape)}, expand={expand}")
    if not 1 <= stop <= ef:
        raise ValueError(f"stop={stop} outside [1, {ef}]")
    for name, t, dt in (("beam_d", beam_d, torch.float32), ("beam_s", beam_s, torch.int32),
                        ("beam_e", beam_e, torch.int32)):
        if tuple(t.shape) != (q_n, ef) or t.dtype != dt or t.device != qb.device:
            raise ValueError(f"{name} must be {dt} {(q_n, ef)} on {qb.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    args = [t.contiguous() for t in (nodes, packed, qb, qn, beam_d, beam_s, beam_e)]
    if use_plain(qb):
        return _fused_expand_plain(*args, ef, expand, stop)
    return _fused_expand_cuda(*args, ef, expand, stop)


# -- search ------------------------------------------------------------------------------


def row_sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Squared norms of float32 rows. The seed scan and the beam take the
    query norms from one call of this, so they read the same values."""
    return (x * x).sum(dim=1)


def _search_init(queries, qn, entry, vectors, sqnorms, allowed, sq_thresh,
                 ef, expand, fused, kr, seed_d=None, seed_s=None):
    """The starting beam, next nodes and result set (reference
    _search_init): from the seeds (a cluster-probe scan, [Q, n_seed] sorted
    by (dist, slot), (+inf, SENT) padded), with the entry point where a
    query's seed row is empty, or from the entry point alone."""
    q_n = queries.shape[0]
    dev = queries.device
    qb = queries.to(torch.bfloat16)
    col = torch.arange(ef, device=dev)[None, :]
    if seed_d is not None:
        n_seed = seed_d.shape[1]
        beam_d = torch.full((q_n, ef), INF, dtype=torch.float32, device=dev)
        beam_s = torch.full((q_n, ef), SENT, dtype=torch.int32, device=dev)
        beam_d[:, :n_seed] = seed_d
        beam_s[:, :n_seed] = seed_s
        # probe-starved queries start from the entry point, scored in the
        # in-loop domain so that its rediscovery is killed as a copy
        empty = (beam_s == SENT).all(dim=1)
        e_ip = bf16_dot(qb, vectors[entry.long()].to(torch.bfloat16))
        e_d = torch.clamp_min((qn + bf16_round(sqnorms[entry.long()])) - 2.0 * e_ip, 0.0)
        beam_d[:, 0] = torch.where(empty, e_d, beam_d[:, 0])
        beam_s[:, 0] = torch.where(empty, entry, beam_s[:, 0])
        valid0 = beam_s != SENT
        first_e = (col < expand) & valid0
        beam_e = first_e.to(torch.int32)
        nodes = torch.where(first_e[:, :expand], beam_s[:, :expand],
                            torch.full_like(beam_s[:, :expand], -1))
        if fused:
            # the admitted rows of the sorted, distinct beam, in order
            adm0 = valid0 & allowed[torch.where(valid0, beam_s, 0).long()] & (beam_d <= sq_thresh)
            order = torch.sort((~adm0).to(torch.int8), dim=1, stable=True).indices
            keep = adm0.gather(1, order)
            res_d = torch.where(keep, beam_d.gather(1, order), torch.full_like(beam_d, INF))
            res_s = torch.where(keep, beam_s.gather(1, order), torch.full_like(beam_s, SENT))
            if ef < kr:
                res_d = torch.cat([res_d, res_d.new_full((q_n, kr - ef), INF)], dim=1)
                res_s = torch.cat([res_s, res_s.new_full((q_n, kr - ef), SENT)], dim=1)
            res_d, res_s = res_d[:, :kr].contiguous(), res_s[:, :kr].contiguous()
        else:
            res_d = res_s = None
        return qb, beam_d, beam_s, beam_e, nodes.contiguous(), res_d, res_s
    ev = vectors[entry.long()]
    e_d = torch.clamp_min((qn + sqnorms[entry.long()]) - 2.0 * (queries * ev).sum(dim=1), 0.0)
    beam_d = torch.full((q_n, ef), INF, dtype=torch.float32, device=dev)
    beam_s = torch.full((q_n, ef), SENT, dtype=torch.int32, device=dev)
    beam_e = torch.zeros((q_n, ef), dtype=torch.int32, device=dev)
    nodes = torch.full((q_n, expand), -1, dtype=torch.int32, device=dev)
    beam_d[:, 0], beam_s[:, 0], beam_e[:, 0], nodes[:, 0] = e_d, entry, 1, entry
    res_d = res_s = None
    if fused:
        ok0 = allowed[entry.long()] & (e_d <= sq_thresh)
        res_d = torch.full((q_n, kr), INF, dtype=torch.float32, device=dev)
        res_s = torch.full((q_n, kr), SENT, dtype=torch.int32, device=dev)
        res_d[:, 0] = torch.where(ok0, e_d, torch.full_like(e_d, INF))
        res_s[:, 0] = torch.where(ok0, entry, torch.full_like(entry, SENT))
    return qb, beam_d, beam_s, beam_e, nodes, res_d, res_s


def _search_finalize(queries, qn, vectors, sqnorms, allowed, sq_thresh,
                     beam_d, beam_s, res_d, res_s, k, fused):
    """Exact float32 re-score of the best kk candidates (K1 select), then
    slot dedup, admission and threshold on the exact distances and the
    (dist, slot) order. Returns (dist [Q, k], slots [Q, k])."""
    cd, cs = (res_d, res_s) if fused else (beam_d, beam_s)
    kk = min(max(2 * k, 64), max(_next_pow2(k), 64), cd.shape[1])
    top_s = topk_rows(cd, cs, kk)[1][:, :kk]
    tv = vectors[torch.where(top_s == SENT, 0, top_s).long()]      # [Q, kk, d]
    ip = (tv * queries[:, None, :]).sum(dim=-1)
    tn = (tv * tv).sum(dim=-1)
    td = torch.clamp_min((qn[:, None] + tn) - ip * 2.0, 0.0)
    # slot dedup: the entry's float32 init distance and its bf16
    # rediscovery are two keys, so both copies can reach here
    order = torch.sort(top_s, dim=1, stable=True).indices
    s2, d2 = top_s.gather(1, order), td.gather(1, order)
    dup = torch.zeros_like(s2, dtype=torch.bool)
    dup[:, 1:] = s2[:, 1:] == s2[:, :-1]
    ok = (~dup & (s2 != SENT) & allowed[torch.where(s2 == SENT, 0, s2).long()]
          & (d2 <= sq_thresh))
    td = torch.where(ok, d2, torch.full_like(d2, INF))
    s2 = torch.where(ok, s2, torch.full_like(s2, SENT))
    return lexsort_topk(td, s2, k)


def beam_search_blocked(queries, entry, nbr_vecs, aux, vectors, sqnorms, allowed,
                        sq_thresh: float, ef: int, k: int, expand: int, max_iters: int,
                        fused: bool, seeds=None, stop: int | None = None, qn=None,
                        fuse: bool = False):
    """Lockstep beam search of every query over the routing tables.

    queries [Q, d] float32 (preprocessed), entry [Q] int32 layer-0 entry
    slots, nbr_vecs [cap, W, d] and aux [cap, (1 + ndig) W] bf16
    (`build_blocked_tables`) or the packed table and aux None
    (`build_packed_table`), vectors [cap, d] and sqnorms [cap] float32,
    allowed [cap] bool (result admission), sq_thresh on the squared
    distance (+inf disables). `seeds` = (seed_d, seed_s) [Q, n_seed <= ef]
    starts from a seed scan; `stop` is the termination row (default ef);
    `qn` the query norms the seeds were scored with (`row_sqnorms`).
    `fuse` runs each iteration as one K5 launch where the reference does
    (packed table, no result set: `fuse and aux is None and not fused`);
    the split path serves the rest.
    Returns (dist [Q, k] squared, slots [Q, k] int32), ascending with the
    slot tie-break, empty = (+inf, SENT)."""
    d = queries.shape[1]
    ew = expand * _table_width(nbr_vecs, d)
    kr = _next_pow2(max(2 * k, 64)) if fused else 0
    if qn is None:
        qn = row_sqnorms(queries)
    seed_d, seed_s = seeds if seeds is not None else (None, None)
    entry = entry.to(torch.int32)
    qb, beam_d, beam_s, beam_e, nodes, res_d, res_s = _search_init(
        queries, qn, entry, vectors, sqnorms, allowed, sq_thresh,
        ef, expand, fused, kr, seed_d, seed_s,
    )
    fuse = fuse and aux is None and not fused
    for it in range(int(max_iters)):
        if fuse:
            beam_d, beam_s, beam_e, misc = fused_expand_merge(
                nodes, nbr_vecs, qb, qn, beam_d, beam_s, beam_e, ef=ef, expand=expand, stop=stop)
        else:
            nd, ns, adm = gather_score(qb, qn, nbr_vecs, aux, nodes, allowed, sq_thresh, fused)
            beam_d, beam_s, beam_e, misc, rd2, rs2 = beam_merge_step(
                beam_d, beam_s, beam_e, nd, ns, res_d, res_s, adm,
                ef=ef, ew=ew, expand=expand, fused=fused, kr=kr, stop=stop,
            )
            if fused:
                res_d, res_s = rd2, rs2
        nodes = misc[:, :expand].contiguous()
        if (it + 1) % ALIVE_EVERY == 0 and not bool((misc[:, expand] > 0).any()):
            break
    return _search_finalize(queries, qn, vectors, sqnorms, allowed, sq_thresh,
                            beam_d, beam_s, res_d, res_s, k, fused)


def nearest_entry(queries, mem_vecs, mem_sqn, mem_slots):
    """Layer-0 entry per query: the nearest upper-layer member by
    mem_sqn - 2 <bf16(q), bf16(member)> (the query norm does not change the
    order), float32 accumulation, the first minimum on ties as JAX's argmin.
    mem_vecs [M, d] float32 holding bf16 values, mem_sqn [M], mem_slots [M]
    int32."""
    ip = f32_matmul(bf16_round(queries), mem_vecs)
    return mem_slots[torch.argmin(mem_sqn[None, :] - 2.0 * ip, dim=1)]
