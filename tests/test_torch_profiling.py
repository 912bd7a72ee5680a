"""comet_tpu_torch.utils.profiling: the spans of tests/test_profiling.py on
torch (each package's Timer measures the same sleep), and its
torch.profiler trace."""

import logging
import time

import pytest
import torch

from comet_tpu.utils import profiling as ref_profiling
from comet_tpu_torch.utils import profiling


@pytest.mark.parametrize("mod", [ref_profiling, profiling], ids=["ref", "port"])
def test_timer_measures_elapsed(mod):
    with mod.Timer("t") as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01


def test_timer_syncs_device_tensors():
    with profiling.Timer("t") as t:
        x = t.sync(torch.ones((8, 8)) * 2)
    assert t.elapsed > 0 and float(x[0, 0]) == 2.0
    assert t.device_elapsed is None  # a CPU span has no device time
    with profiling.Timer("t") as t:
        a, b = t.sync(torch.zeros(2), torch.ones(2))
    assert float(b.sum()) == 2.0


def test_timed_contextmanager(caplog):
    with caplog.at_level(logging.DEBUG, logger="comet_tpu_torch.profiling"):
        with profiling.timed("span") as t:
            pass
    assert t.elapsed >= 0 and "span:" in caplog.text


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones((64, 64)) @ torch.ones((64, 64))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
