"""comet_tpu_torch.ops.sortnet (K1 top-k select) against the reference's
Pallas `topk_cl`, run in interpret mode on the CPU.

The port's CPU path is the plain PyTorch version of the kernel; the card
test (tests/test_torch_cuda.py) holds the CUDA kernel to that version.
Inputs come from a seeded numpy generator and go to both packages. Bar:
values and indices array-equal.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import sortnet as ref
from comet_tpu_torch.ops import sortnet

# (C, k): C a power of two or not, below and above k_pow2
SHAPES = {1: 64, 10: 200, 100: 100}
L_REAL = 130  # not a multiple of the reference's 128 lanes
# columns of one input: random values, few distinct values, signed zeros
CASES = {"random": slice(0, 50), "ties": slice(50, 100), "zeros": slice(100, 130)}


def _inputs(k):
    c = SHAPES[k]
    rng = np.random.default_rng(1000 + k)
    v = np.empty((c, L_REAL), np.float32)
    v[:, CASES["random"]] = rng.normal(size=(c, 50))
    v[:, CASES["ties"]] = rng.integers(0, 4, size=(c, 50))
    v[:, CASES["zeros"]] = rng.choice(
        np.array([-0.0, 0.0, 1.0, np.inf], np.float32), size=(c, 30)
    )
    # unique indices per column, in random order
    idx = np.stack([rng.permutation(c) for _ in range(L_REAL)], axis=1).astype(np.int32)
    return v, idx


@lru_cache(maxsize=None)
def _reference(k):
    v, idx = _inputs(k)
    rv, ri = ref.topk_cl(jnp.asarray(v), jnp.asarray(idx), k, interpret=True)
    return np.asarray(rv), np.asarray(ri)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("k", list(SHAPES))
def test_topk_cl_matches_reference(k, case):
    v, idx = _inputs(k)
    rv, ri = _reference(k)
    pv, pi = sortnet.topk_cl(torch.from_numpy(v), torch.from_numpy(idx), k)
    assert pv.shape == rv.shape == (sortnet.k_pow2(k), L_REAL)
    cols = CASES[case]
    np.testing.assert_array_equal(pi.numpy()[:, cols], ri[:, cols])
    np.testing.assert_array_equal(pv.numpy()[:, cols], rv[:, cols])


@pytest.mark.parametrize("k", list(SHAPES))
def test_topk_rows_matches_reference(k):
    """The row-per-query layout the pipeline uses selects the same."""
    v, idx = _inputs(k)
    rv, ri = _reference(k)
    pv, pi = sortnet.topk_rows(
        torch.from_numpy(v.T.copy()), torch.from_numpy(idx.T.copy()), k
    )
    np.testing.assert_array_equal(pi.numpy().T, ri)
    np.testing.assert_array_equal(pv.numpy().T, rv)


# Repeated keys at a width just past k_pow2 (C = 129 for k = 100): values
# and indices both repeat in the "pairs" columns, so whole (value, index)
# keys repeat across the boundary.
EDGE_K = 100
EDGE_C = sortnet.k_pow2(EDGE_K) + 1
EDGE_CASES = {"random": slice(0, 30), "ties": slice(30, 60), "equal": slice(60, 90),
              "pairs": slice(90, 130)}


def _edge_inputs():
    rng = np.random.default_rng(77)
    v = np.empty((EDGE_C, L_REAL), np.float32)
    v[:, EDGE_CASES["random"]] = rng.normal(size=(EDGE_C, 30))
    v[:, EDGE_CASES["ties"]] = rng.integers(0, 4, size=(EDGE_C, 30))
    v[:, EDGE_CASES["equal"]] = 2.5
    v[:, EDGE_CASES["pairs"]] = rng.integers(0, 3, size=(EDGE_C, 40))
    idx = np.stack([rng.permutation(EDGE_C) for _ in range(L_REAL)], axis=1).astype(np.int32)
    idx[:, EDGE_CASES["pairs"]] = rng.integers(0, 5, size=(EDGE_C, 40))
    return v, idx


@lru_cache(maxsize=None)
def _edge_reference():
    v, idx = _edge_inputs()
    rv, ri = ref.topk_cl(jnp.asarray(v), jnp.asarray(idx), EDGE_K, interpret=True)
    return np.asarray(rv), np.asarray(ri)


@pytest.mark.parametrize("layout", ["cl", "rows"])
@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_repeated_keys_just_past_kp_match_reference(case, layout):
    """The plain versions, which the card holds the kernel to, select what
    the reference selects where keys repeat across the boundary."""
    v, idx = _edge_inputs()
    rv, ri = _edge_reference()
    if layout == "cl":
        pv, pi = sortnet.topk_cl(torch.from_numpy(v), torch.from_numpy(idx), EDGE_K)
    else:
        pv, pi = sortnet.topk_rows(torch.from_numpy(v.T.copy()), torch.from_numpy(idx.T.copy()),
                                   EDGE_K)
        pv, pi = pv.T, pi.T
    cols = EDGE_CASES[case]
    np.testing.assert_array_equal(pi.numpy()[:, cols], ri[:, cols])
    np.testing.assert_array_equal(pv.numpy()[:, cols], rv[:, cols])


def test_signed_zero_comes_back_positive():
    """-0.0 ties +0.0 and is ordered by index; the port returns it as +0.0
    (the reference keeps the sign bit; the two compare equal)."""
    v = torch.tensor([[-0.0], [0.0], [-0.0]], dtype=torch.float32)
    i = torch.tensor([[5], [3], [4]], dtype=torch.int32)
    pv, pi = sortnet.topk_cl(v, i, 3)
    assert pi[:3, 0].tolist() == [3, 4, 5]
    assert not torch.signbit(pv[:3]).any()


def test_positions_as_indices_and_padding():
    """idx=None ranks by position; short rows pad with (+inf, sentinel)."""
    v = torch.tensor([[2.0, 1.0, 2.0]])
    pv, pi = sortnet.topk_rows(v, None, 5)
    assert pi[0].tolist() == [1, 0, 2] + [sortnet.IDX_SENTINEL] * 5
    assert torch.isinf(pv[0, 3:]).all()


def test_nan_is_rejected():
    with pytest.raises(ValueError):
        sortnet.topk_cl(torch.tensor([[float("nan")]]), torch.zeros((1, 1), dtype=torch.int32), 1)


def test_other_devices_raise():
    """No silent fallback: a tensor neither on the CPU nor on a card raises."""
    v = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError):
        sortnet.topk_cl(v, torch.zeros((4, 2), dtype=torch.int32, device="meta"), 2)
