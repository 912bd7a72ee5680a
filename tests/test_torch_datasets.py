"""comet_tpu_torch.io.datasets against comet_tpu.io.datasets: the loaders
of tests/test_datasets.py on the same files give the same arrays."""

import numpy as np
import pytest

from comet_tpu.io import datasets as ref_datasets
from comet_tpu_torch.io import datasets


def _write_fvecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = arr.astype(np.float32).view(np.int32)
    out.tofile(path)


def _write_ivecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = arr
    out.tofile(path)


def _write_bvecs(path, arr):
    n, d = arr.shape
    out = np.empty((n, 4 + d), dtype=np.uint8)
    out[:, :4] = np.frombuffer(np.int32(d).tobytes(), dtype=np.uint8)
    out[:, 4:] = arr
    out.tofile(path)


def _both(fn, *args, **kw):
    got, want = getattr(datasets, fn)(*args, **kw), getattr(ref_datasets, fn)(*args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)
    return got


def test_fvecs_roundtrip(tmp_path, rng):
    arr = rng.normal(size=(37, 16)).astype(np.float32)
    _write_fvecs(tmp_path / "x.fvecs", arr)
    np.testing.assert_array_equal(_both("read_fvecs", tmp_path / "x.fvecs"), arr)
    np.testing.assert_array_equal(_both("read_fvecs", tmp_path / "x.fvecs", limit=5), arr[:5])


def test_ivecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 10**6, size=(11, 100)).astype(np.int32)
    _write_ivecs(tmp_path / "gt.ivecs", arr)
    np.testing.assert_array_equal(_both("read_ivecs", tmp_path / "gt.ivecs"), arr)


def test_bvecs_roundtrip(tmp_path, rng):
    arr = rng.integers(0, 256, size=(9, 128)).astype(np.uint8)
    _write_bvecs(tmp_path / "x.bvecs", arr)
    np.testing.assert_array_equal(_both("read_bvecs", tmp_path / "x.bvecs"),
                                  arr.astype(np.float32))


def test_load_sift_dir(tmp_path, rng):
    base = rng.normal(size=(50, 8)).astype(np.float32)
    queries = rng.normal(size=(7, 8)).astype(np.float32)
    gt = rng.integers(0, 50, size=(7, 10)).astype(np.int32)
    _write_fvecs(tmp_path / "sift_base.fvecs", base)
    _write_fvecs(tmp_path / "sift_query.fvecs", queries)
    _write_ivecs(tmp_path / "sift_groundtruth.ivecs", gt)
    b, q, g = _both("load_sift_dir", tmp_path)
    assert np.array_equal(b, base) and np.array_equal(q, queries) and np.array_equal(g, gt)
    b2, q2, g2 = _both("load_sift_dir", tmp_path, max_base=10, max_queries=3)
    assert b2.shape == (10, 8) and q2.shape == (3, 8) and g2.shape == (3, 10)


def test_load_sift_dir_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        datasets.load_sift_dir(tmp_path)


def test_corrupt_fvecs(tmp_path, rng):
    _write_fvecs(tmp_path / "x.fvecs", rng.normal(size=(5, 8)).astype(np.float32))
    raw = np.fromfile(tmp_path / "x.fvecs", dtype=np.int32)
    raw[9] = 99  # a dim header mid-file
    raw.tofile(tmp_path / "x.fvecs")
    for mod in (datasets, ref_datasets):
        with pytest.raises(ValueError):
            mod.read_fvecs(tmp_path / "x.fvecs")
