"""Plain reference of IVF k-NN search under L2, in PyTorch float64.

Semantics (comet's IVF; the configuration gives nlist, nprobe and k):
- lists: each corpus row belongs to the list of its nearest centroid,
  ties to the lowest centroid index;
- probes: a query searches the lists of its nprobe nearest centroids,
  ties to the lowest index;
- results: the k nearest rows of the probed lists by (squared distance,
  id), ids slot + 1, scores the correctly rounded float32 roots
  (flat_l2.knn with an `allowed` mask).

The centroids are the deployment's learned parameters, `data["centroids"]`
(systems/ivf.py hands over a host float32 copy of the program's): k-means
in float32 over 20 iterations is not reproduced bit for bit by another
program. The reference learns its own by plain Lloyd iterations in
float64 on the same training rows (stride init, ties to the lowest index,
an empty list keeps its centroid, the configuration's `train_rows` and
`kmeans_iters`) and holds the handed-over table to them: the k-means
objective on the training rows (the mean squared distance of a row to its
nearest centroid) may exceed its own by at most OBJECTIVE_LIMIT of it,
and the median distance of a centroid from its float64 counterpart may
be at most SHIFT_LIMIT. (Not the largest: where the data is continuous,
a near tie that float32 and float64 break apart hands a few centroids to
other regions within 20 iterations, so a sound table has single
centroids as far from their counterparts as a table trained one
iteration.) A table outside either limit is refused: the reference then
answers every request with no result, so each place the program returns
counts as a mismatch. Within them, everything downstream of the table is
worked out here, in float64, from the benchmark's own corpus and queries.
Where the data holds no centroids (the control, which runs no program),
the reference's own are used. Nothing of the program is imported or read.

Distances between two rows of integers are exact (flat_l2.py); distances
to a centroid are not. The program computes ||a||^2 + ||c||^2 - 2 a.c in
float32 (a query's probes drop ||a||^2), then a root: sums of d products,
two additions and the root each round, so its error lies below
g (||a||^2 + ||c||^2 + 2 |a|.|c|) <= g (||a|| + ||c||)^2 with
g = m u / (1 - m u), u = 2^-24 and m = d + EXTRA_ROUNDINGS, in whatever
order the sums run. Two distances of one vector a can therefore come out
of the program in either order when their float64 values lie within

    tau(a) = 2 g (||a|| + C)^2,   C the largest centroid norm,

a few tens here (||a|| ~ 610, centroid norms below ~1,000, d = 128),
against squared distances of ~2-6 * 10^4. A request is undecided, and not compared, when
(a) its nprobe-th and (nprobe + 1)-th centroid distances lie within
    tau(query): the probed set is not decided; or
(b) a row whose nearest centroid distance has another within tau(row)
    (its candidate lists: every centroid within tau of the nearest), and
    whose candidate lists differ in probed status for the query, lies at
    or inside the request's k-th distance: its list is not decided.

`precision="control"`: the scan's squared distances carried in TF32
(flat_l2.py), the precision below the configuration's float32 with TF32
off; the lists and probes stay as they are."""

import sys

import numpy as np
import torch

from harness.spec import load_module

flat_l2 = load_module("references", "flat_l2")

U = 2.0 ** -24
# Limits of a handed-over centroid table against the float64 Lloyd, set
# from the program's k-means at the configuration's full size on the card
# (PERF.md, §2). Sound, over 15 seeds: objective excesses -9.0e-5 to
# +1.7e-4, median shifts 3.8-6.8. Trained 1 iteration: +7.9e-2 to 8.2e-2
# and 72-74; on a quarter of the rows: +5.3e-2 to 5.5e-2 and 473-518; 15
# iterations, or nine tenths of the rows: +1.9e-3 or more (the smallest
# planted faults the objective still refuses).
OBJECTIVE_LIMIT = 1e-3
SHIFT_LIMIT = 20.0
EXTRA_ROUNDINGS = 4     # the two additions, the root (twice its relative error)
BLOCK = 1 << 16         # corpus rows a block of the assignment


def tolerance(norms: torch.Tensor, c_max: float, d: int) -> torch.Tensor:
    """tau of each vector, from its norm: the module docstring's bound."""
    m = d + EXTRA_ROUNDINGS
    g = m * U / (1.0 - m * U)
    return 2.0 * g * (norms + c_max) ** 2


def sqdist(a: torch.Tensor, c: torch.Tensor, cn: torch.Tensor) -> torch.Tensor:
    """[A, nlist] float64 squared distances of rows a to centroids c."""
    return (a * a).sum(1, keepdim=True) + cn[None, :] - 2.0 * (a @ c.T)


def nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    cn = (c * c).sum(1)
    return torch.cat([torch.argmin(sqdist(x[r0:r0 + BLOCK], c, cn), dim=1)   # first minimum
                      for r0 in range(0, x.shape[0], BLOCK)])


def lloyd(x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """Plain k-means in float64: the reference's own centroids, which a
    handed-over table is held to and the control uses."""
    n = x.shape[0]
    c = x[torch.clamp_max(torch.arange(k, device=x.device) * max(n // k, 1), n - 1)].clone()
    assign = None
    for _ in range(iters):
        a = nearest(x, c)
        if assign is not None and torch.equal(a, assign):
            break
        assign = a
        sums = torch.zeros_like(c).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).to(x.dtype)[:, None]
        c = torch.where(counts > 0, sums / counts.clamp_min(1.0), c)
    return c


def objective(x: torch.Tensor, c: torch.Tensor) -> float:
    """The k-means objective: mean squared distance of a row of x to its
    nearest centroid, float64."""
    cn = (c * c).sum(1)
    return sum(float(sqdist(x[r0:r0 + BLOCK], c, cn).min(dim=1).values.sum())
               for r0 in range(0, x.shape[0], BLOCK)) / x.shape[0]


def hold(train: torch.Tensor, given: torch.Tensor, own: torch.Tensor) -> dict:
    """The handed-over table against the reference's own: the objective's
    relative excess, the median and largest centroid shifts, and whether
    the excess and the median lie within their limits. Printed to
    standard error."""
    if given.shape != own.shape:
        out = {"objective_excess": float("inf"), "median_shift": float("inf"),
               "largest_shift": float("inf")}
    else:
        shift = (given - own).norm(dim=1)
        out = {"objective_excess": objective(train, given) / objective(train, own) - 1.0,
               "median_shift": float(shift.median()), "largest_shift": float(shift.max())}
    out["accepted"] = bool(out["objective_excess"] <= OBJECTIVE_LIMIT
                           and out["median_shift"] <= SHIFT_LIMIT)
    print(f"centroids: objective excess {out['objective_excess']:.3e} (limit "
          f"{OBJECTIVE_LIMIT:.0e}), median shift {out['median_shift']:.4g} (limit "
          f"{SHIFT_LIMIT:g}), largest {out['largest_shift']:.4g}: "
          f"{'accepted' if out['accepted'] else 'refused'}", file=sys.stderr, flush=True)
    return out


def lists(cell, data) -> dict:
    """The list structure, worked out once a run (kept in `data`):
    centroids [nlist, d] and their squared norms, float64; `held`, the
    handed-over table's check (None for the reference's own table); each
    row's list `assign` [n]; the rows whose list is not decided
    (`amb_rows`) and their candidate lists (`amb_cands`, [A, nlist]
    bool); `c_max`."""
    if "ivf_lists" in data:
        return data["ivf_lists"]
    cf = cell["config_spec"]
    corpus = data["corpus"]
    dev = corpus.device
    train = corpus[:cf["train_rows"]].to(torch.float64)
    c = lloyd(train, cf["nlist"], cf["kmeans_iters"])
    held = None
    if "centroids" in data:
        given = torch.as_tensor(np.asarray(data["centroids"]), device=dev).to(torch.float64)
        held = hold(train, given, c)
        c = given
    cn = (c * c).sum(1)
    c_max = float(cn.max().sqrt())
    assign, amb_rows, amb_cands = [], [], []
    for r0 in range(0, corpus.shape[0], BLOCK):
        x = corpus[r0:r0 + BLOCK].to(torch.float64)
        dist = sqdist(x, c, cn)
        assign.append(torch.argmin(dist, dim=1))
        low = torch.topk(dist, min(2, dist.shape[1]), dim=1, largest=False).values
        tau = tolerance(x.norm(dim=1), c_max, x.shape[1])
        amb = (low[:, -1] - low[:, 0] <= tau) if low.shape[1] > 1 else torch.zeros_like(tau).bool()
        if bool(amb.any()):
            rows = torch.nonzero(amb).flatten()
            amb_rows.append(rows + r0)
            amb_cands.append(dist[rows] - low[rows, :1] <= tau[rows, None])
    nlist = c.shape[0]
    out = {"centroids": c, "cn": cn, "c_max": c_max, "assign": torch.cat(assign), "held": held,
           "amb_rows": (torch.cat(amb_rows) if amb_rows
                        else torch.zeros(0, dtype=torch.int64, device=dev)),
           "amb_cands": (torch.cat(amb_cands) if amb_cands
                         else torch.zeros((0, nlist), dtype=torch.bool, device=dev))}
    data["ivf_lists"] = out
    return out


def probes(lst: dict, queries: torch.Tensor, nprobe: int):
    """(probed [Q, nlist] bool, undecided [Q] bool by rule (a)) of float64
    queries: the nprobe nearest centroids, ties to the lowest index."""
    dist = sqdist(queries, lst["centroids"], lst["cn"])
    val, order = torch.sort(dist, dim=1, stable=True)
    probed = torch.zeros_like(dist, dtype=torch.bool).scatter_(1, order[:, :nprobe], True)
    if nprobe >= dist.shape[1]:
        return probed, torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
    tau = tolerance(queries.norm(dim=1), lst["c_max"], queries.shape[1])
    return probed, val[:, nprobe] - val[:, nprobe - 1] <= tau


def expected(cell, data, reqs, picks, cats, precision="exact"):
    """(ids, scores, decided) of each request in `picks`, in the order the
    cell's entry returns them: a batch row by (squared distance, id), a
    fluent list by (score, id)."""
    cf, k = cell["config_spec"], cell["traffic_spec"]["k"]
    order = "distance" if cell["traffic_spec"]["entry"] == "search_batch" else "score"
    lst = lists(cell, data)
    if lst["held"] is not None and not lst["held"]["accepted"]:
        none = np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)
        return [(*none, True) for _ in picks]
    corpus = data["corpus"]
    queries = data["pool"][torch.as_tensor(reqs.rows[picks], device=corpus.device)]
    q64 = queries.to(torch.float64)
    probed, undecided = probes(lst, q64, cf["nprobe"])
    assign = lst["assign"]
    ids, d2 = flat_l2.knn(corpus, queries, k, lambda q0, q1: probed[q0:q1][:, assign], precision)
    if len(lst["amb_rows"]):
        cands = lst["amb_cands"].to(torch.float64)
        hit = (probed.to(torch.float64) @ cands.T) > 0            # [Q, A]
        miss = ((~probed).to(torch.float64) @ cands.T) > 0
        x = corpus[lst["amb_rows"]].to(torch.float64)
        near = sqdist(q64, x, (x * x).sum(1)) <= torch.as_tensor(
            d2[:, -1], device=corpus.device)[:, None]
        undecided |= (hit & miss & near).any(dim=1)
    undecided = undecided.cpu().numpy()
    return [(i, s, not bool(u)) for (i, s), u in zip(flat_l2.rows(ids, d2, order), undecided)]
