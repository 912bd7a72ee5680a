"""The benchmark's IVF cell (cardbench/, imported as its own tests import
it) on the CPU at a tiny size, on each route of the port's IVF search:
the comparison passes the program, and fails an answer altered where it
is produced, the program searching one list short, the program's
centroids trained short, and the control; the plain reference's IVF
equals the port's IVFIndex on integer data; the data repeats from its seed."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDBENCH_TESTS = os.path.join(REPO, "cardbench", "tests")
if CARDBENCH_TESTS not in sys.path:
    sys.path.insert(0, CARDBENCH_TESTS)

from cardbench_tiny import tiny_cell  # noqa: E402  (puts cardbench/ on the path)
from harness import checks, spec, traffic  # noqa: E402

import run  # noqa: E402  (cardbench/run.py)

import comet_tpu_torch as ct  # noqa: E402

CELL = "ivf-batch2048"
SEED = 2 ** 33 + 29
NLIST = 32          # 4096 rows: ~128 a list, so nprobe 10 probes ~1,280 rows for k = 100
SECONDS = 1.0
ROUTES = {"sparse": "1", "dense": "0"}

ivf_l2 = spec.load_module("references", "ivf_l2")


@pytest.fixture(autouse=True)
def keep_whole_calls(monkeypatch):
    """Every row of a window's call kept for the check, so that two calls
    give the comparison its sample however slow the host runs."""
    monkeypatch.setattr(run, "KEEP_PER_CALL", tiny_cell(CELL)["traffic_spec"]["batch"])


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    monkeypatch.setenv("COMET_IVF_SPARSE", ROUTES[request.param])
    return request.param


def tiny_ivf_cell():
    cell = tiny_cell(CELL)
    cell["config_spec"]["nlist"] = NLIST
    return cell


def run_tiny(hook=None):
    return run.run(tiny_ivf_cell(), SEED, SECONDS, False, "cpu", system_hook=hook)[0]


class Patched:
    """The system with `batch` replaced, everything else its own."""

    def __init__(self, system, batch):
        self.system, self.batch = system, batch

    def __getattr__(self, name):
        return getattr(self.system, name)


def test_a_tiny_run_is_correct(route):
    result = run_tiny()
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    checked = result["checks"]
    assert checked["mismatched_results"]["value"] == 0
    assert checked["checked_requests"]["value"] >= checks.MIN_CHECKED


def test_an_answer_altered_where_it_is_produced_is_not_correct(route):
    def altered(system):
        def batch(reqs, lo, hi, k):
            ids, scores = system.batch(reqs, lo, hi, k)
            ids = ids.copy()
            ids[:, 0] = ids[:, 1]
            return ids, scores
        return Patched(system, batch)

    result = run_tiny(altered)
    assert result["correct"] is False and result["checks"]["mismatched_results"]["value"] > 0


def test_the_program_one_probe_short_is_not_correct(route):
    def short(system):
        system.nprobe -= 1
        return system

    result = run_tiny(short)
    assert result["correct"] is False and result["checks"]["mismatched_results"]["value"] > 0


@pytest.mark.parametrize("fault", ["one_iteration", "a_quarter_of_the_rows"])
def test_centroids_trained_short_are_refused(route, fault, monkeypatch):
    """The program's k-means cut short, by iterations or by training rows:
    the reference's own float64 Lloyd refuses the handed-over table, so
    the run reads not correct whatever lists and probes follow from it."""
    train = ct.IVFIndex.train

    def short(self, vectors, max_iter=20):
        if fault == "one_iteration":
            return train(self, vectors, max_iter=1)
        return train(self, vectors[: len(vectors) // 4], max_iter=max_iter)

    monkeypatch.setattr(ct.IVFIndex, "train", short)
    result = run_tiny()
    assert result["correct"] is False and result["checks"]["mismatched_results"]["value"] > 0


def test_the_control_is_not_correct(route):
    out = checks.control(tiny_ivf_cell(), SEED, SECONDS, "cpu")
    assert out["correct"] is False and out["control_mismatched_results"] > 0
    assert out["checked_requests"] >= checks.MIN_CHECKED


def test_the_reference_equals_the_port_on_integer_data(route):
    """The reference, handed the port's centroids, lists the same rows,
    probes the same lists and returns the same ids and scores, in the
    same order, on every request it decides."""
    cell = tiny_ivf_cell()
    cf, tr = cell["config_spec"], cell["traffic_spec"]
    cf.update(n=3000, nlist=16, nprobe=4, train_rows=1000)
    tr.update(k=20)
    data = {}
    for name in cf["generators"]:
        spec.load_module("generators", name).make(cf, SEED, "cpu", data)
    index = ct.IVFIndex(cf["dim"], cf["nlist"], ct.DistanceKind.L2, device="cpu")
    index.train(data["corpus"][:cf["train_rows"]].numpy())
    index.add_batch(data["corpus"].numpy(), ids=np.arange(1, cf["n"] + 1, dtype=np.uint32))
    data["centroids"] = index._centroids.copy()
    reqs = traffic.requests(tr, cf, SEED, 96, "equal")
    ids, scores = index.search_batch(data["pool"].numpy()[reqs.rows], k=20, nprobes=4)
    want = ivf_l2.expected(cell, data, reqs, np.arange(96), [None] * 96)
    decided = [j for j, w in enumerate(want) if w[2]]
    assert len(decided) >= 64
    lists = ivf_l2.lists(cell, data)
    amb = set(lists["amb_rows"].tolist())
    same = [s for s in range(cf["n"]) if s not in amb]
    assert np.array_equal(index._assign[same], lists["assign"][same].numpy())
    for j in decided:
        assert np.array_equal(ids[j].astype(np.int64), want[j][0])
        assert np.array_equal(scores[j].astype(np.float64), want[j][1])


def test_the_ivf_data_repeats_from_the_seed_and_stays_in_sift_range():
    """The configuration's generator: the same seed gives the same corpus
    and pool, another seed others; rows of integers 0..255."""
    cf = tiny_ivf_cell()["config_spec"]

    def make(seed):
        data = {}
        for name in cf["generators"]:
            spec.load_module("generators", name).make(cf, seed, "cpu", data)
        return data

    a, b, c = make(SEED), make(SEED), make(SEED + 1)
    assert torch.equal(a["corpus"], b["corpus"]) and torch.equal(a["pool"], b["pool"])
    assert not torch.equal(a["corpus"], c["corpus"])
    x = a["corpus"]
    assert x.shape == (cf["n"], cf["dim"]) and a["pool"].shape == (cf["pool"], cf["dim"])
    assert torch.equal(x, x.round()) and float(x.min()) == 0.0 and float(x.max()) <= 255.0


def test_the_reference_tolerance_covers_the_float32_error():
    """tau bounds the float32 error of ||a||^2 + ||c||^2 - 2 a.c at the
    configuration's magnitudes: the program's distances lie within tau / 2
    of the float64 ones."""
    g = torch.Generator().manual_seed(5)
    a = torch.randint(0, 256, (512, 128), generator=g).to(torch.float32)
    c = torch.rand((64, 128), generator=g) * 255.0
    got = (a * a).sum(1, keepdim=True) + (c * c).sum(1)[None, :] - 2.0 * (a @ c.T)
    a64, c64 = a.double(), c.double()
    want = ivf_l2.sqdist(a64, c64, (c64 * c64).sum(1))
    tau = ivf_l2.tolerance(a64.norm(dim=1), float(c64.norm(dim=1).max()), 128)
    err = (got.double() - want).abs().amax(dim=1)
    assert bool((err <= tau / 2).all())
    assert 50.0 < float(tau.median()) < 400.0
