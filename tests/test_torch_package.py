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
from comet_tpu_torch import DistanceKind, FlatIndex, InvalidConfigError, IVFIndex
from comet_tpu_torch.ops import _build

PKG = os.path.dirname(comet_tpu_torch.__file__)
ROOT = os.path.dirname(PKG)


def test_import_loads_no_jax():
    code = (
        "import sys, comet_tpu_torch\n"
        "from comet_tpu_torch import FlatIndex, IVFIndex\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'comet_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|comet_tpu)\b", re.M)
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    assert not pattern.search(f.read()), name


@pytest.mark.parametrize("source,replaces", [
    ("topk.cu", "comet_tpu/ops/sortnet.py:_kernel"),
    ("fused_scan.cu", "comet_tpu/ops/pallas_scan.py:_kernel"),
    ("ivf_sparse.cu", "comet_tpu/ops/ivf_sparse.py:_sparse_kernel"),
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
        _build.check(1, "topk_pass")
    _build.check(0, "topk_pass")


def test_cuda_index_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    with pytest.raises(InvalidConfigError):
        FlatIndex(4, DistanceKind.L2, device="cuda")


@pytest.mark.parametrize("cls", [FlatIndex, IVFIndex])
@pytest.mark.parametrize("device", [None, "mps", "meta"])
def test_index_device_is_explicit(device, cls):
    """An omitted device means the card: without one the index raises, as
    it does for a device other than "cpu" or "cuda"; nothing falls back to
    the CPU."""
    args = (4, DistanceKind.L2) if cls is FlatIndex else (4, 2, DistanceKind.L2)
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
