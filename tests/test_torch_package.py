"""Package rules of comet_tpu_torch: it never imports JAX or comet_tpu,
ships its kernel sources, never falls back from the card to the CPU, and a
failed kernel build raises."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import comet_tpu_torch
from comet_tpu_torch import (
    BM25SearchIndex,
    DistanceKind,
    FlatIndex,
    HNSWIndex,
    InvalidConfigError,
    IVFIndex,
)
from comet_tpu_torch.ops import _build

PKG = os.path.dirname(comet_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)


def test_import_loads_no_jax():
    code = (
        "import sys, comet_tpu_torch\n"
        "from comet_tpu_torch import FlatIndex, HNSWIndex, IVFIndex\n"
        "import comet_tpu_torch.ops.beam_kernel, comet_tpu_torch.ops.graph_build\n"
        "from comet_tpu_torch import BM25SearchIndex, HybridSearchIndex, RoaringMetadataIndex\n"
        "import comet_tpu_torch.ops.bm25, comet_tpu_torch.indexes.contracts\n"
        "import comet_tpu_torch.storage, comet_tpu_torch.storage.bloom\n"
        "import comet_tpu_torch.storage.wal, comet_tpu_torch.storage.merge\n"
        "import comet_tpu_torch.io.siftgen, comet_tpu_torch.io.datasets\n"
        "import comet_tpu_torch.utils.profiling, comet_tpu_torch.parallel\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'comet_tpu', 'regex')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|comet_tpu|regex)\b", re.M)
    seen = set()
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                seen.add(os.path.relpath(os.path.join(dirpath, name), PKG))
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name
    for module in ("storage/engine.py", "storage/wal.py", "storage/bloom.py",
                   "storage/merge.py", "storage/memtable.py", "storage/provider.py",
                   "storage/segment.py", "io/siftgen.py", "io/datasets.py",
                   "utils/profiling.py", "parallel/sharded.py"):
        assert module in seen, module


def test_storage_names_are_exported():
    import comet_tpu_torch.storage as storage

    for name in ("StorageConfig", "default_storage_config", "PersistentHybridIndex",
                 "open_persistent_hybrid_index"):
        assert name in comet_tpu_torch.__all__
        assert getattr(comet_tpu_torch, name) is getattr(storage, name)


def test_reference_public_names_are_exported():
    """Every public name of comet_tpu is one of the port's, among them the
    node and aggregation helpers of comet_tpu/core."""
    import comet_tpu

    from comet_tpu_torch.core import aggregation, node

    assert set(comet_tpu.__all__) <= set(comet_tpu_torch.__all__)
    for name, module in (("new_vector_node", node), ("new_vector_node_with_id", node),
                         ("aggregate_vector_results", aggregation),
                         ("aggregate_text_results", aggregation)):
        assert name in comet_tpu_torch.__all__
        assert getattr(comet_tpu_torch, name) is getattr(module, name)


def test_parallel_names_are_the_reference_s():
    import comet_tpu.parallel

    import comet_tpu_torch.parallel

    assert comet_tpu_torch.parallel.__all__ == comet_tpu.parallel.__all__
    for name in comet_tpu_torch.parallel.__all__:
        assert hasattr(comet_tpu_torch.parallel, name)


@pytest.mark.parametrize("source,replaces", [
    ("topk.cu", "comet_tpu/ops/sortnet.py:_kernel"),
    ("fused_scan.cu", "comet_tpu/ops/pallas_scan.py:_kernel"),
    ("ivf_sparse.cu", "comet_tpu/ops/ivf_sparse.py:_sparse_kernel"),
    ("beam_merge.cu", "comet_tpu/ops/beam_kernel.py:_merge_kernel"),
    ("gather_score.cu", "comet_tpu/ops/beam_kernel.py:_gather_score"),
    ("bm25_score.cu", "comet_tpu/indexes/bm25.py:_bm25_device_kernel"),
])
def test_kernel_sources_exist_with_their_note(source, replaces):
    path = os.path.join(_build.CSRC_DIR, source)
    assert path in _build.sources()
    with open(path) as f:
        head = f.read(2000)
    assert head.startswith("//") and replaces in head
    assert "What bounds it" in head


def test_build_flags_target_hopper_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the first kernel call raise, not fall back."""
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'error: broken toolkit' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="broken toolkit"):
        _build.library()
    assert _build._lib is None


def test_launch_error_code_raises():
    with pytest.raises(RuntimeError, match="error 1"):
        _build.check(1, "topk_select")
    _build.check(0, "topk_select")


def test_cuda_index_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    with pytest.raises(InvalidConfigError):
        FlatIndex(4, DistanceKind.L2, device="cuda")


@pytest.mark.parametrize("cls", [FlatIndex, IVFIndex, HNSWIndex, BM25SearchIndex])
@pytest.mark.parametrize("device", [None, "mps", "meta"])
def test_index_device_is_explicit(device, cls):
    """An omitted device means the card: without one the index raises, as
    it does for a device other than "cpu" or "cuda"; nothing falls back to
    the CPU."""
    args = ((4, 2, DistanceKind.L2) if cls is IVFIndex
            else () if cls is BM25SearchIndex else (4, DistanceKind.L2))
    if device is None and torch.cuda.is_available():
        assert cls(*args)._device.type == "cuda"
        return
    with pytest.raises(InvalidConfigError):
        if device is None:
            cls(*args)
        else:
            cls(*args, device=device)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edit to a shared .cuh header rebuilds the library, as an edit to
    a .cu source does."""
    (tmp_path / "a.cu").write_text('#include "t.cuh"\n')
    (tmp_path / "t.cuh").write_text("#define X 1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    key = lambda: _build._source_hash(_build.sources() + _build.headers())  # noqa: E731
    before = key()
    (tmp_path / "t.cuh").write_text("#define X 2\n")
    assert key() != before


def test_cpu_index_reports_its_memory():
    idx = FlatIndex(4, DistanceKind.L2, device="cpu")
    idx.add_batch(np.ones((10, 4), np.float32), ids=range(10))
    idx.search_batch(np.ones((2, 4), np.float32), k=3)
    st = idx.stats()
    assert st["device"] == "cpu" and st["device_synced"]
    assert st["memory"]["device_total"] == 0
    assert st["memory"]["host"]["store"] >= idx._store.vectors.nbytes


def test_cuda_marker_is_registered(request):
    assert any(m.startswith("cuda:") for m in request.config.getini("markers"))


def test_contracts_hold_for_every_index():
    comet_tpu_torch.check_contracts(device="cpu")
