"""comet_tpu_torch.ops.quantizer against comet_tpu.ops.quantizer.

Inputs come from a seeded numpy generator and go to both packages. Bar:
quantized values and their dequantized float32 values array-equal (the
bf16 quantizer's torch tensor bit-equal to the reference's ml_dtypes
array), the same trained state and the same errors.
"""

import numpy as np
import pytest
import torch

from comet_tpu.ops import quantizer as ref
import comet_tpu_torch
from comet_tpu_torch import InvalidConfigError
from comet_tpu_torch.ops import quantizer as port

TYPES = ["float32", "float16", "bfloat16", "int8"]


def _data(seed=0, shape=(6, 9)):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=shape) * 50.0).astype(np.float32)
    v.flat[0] = 0.0
    return v


def _trained(q_type, v):
    r, p = ref.new_quantizer(q_type), port.new_quantizer(q_type)
    r.train(v)
    p.train(v)
    return r, p


def _bits(a):
    """Raw bits of a quantized array: numpy, or a torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("q_type", TYPES)
@pytest.mark.parametrize("shape", [(6, 9), (9,)], ids=["batch", "vector"])
def test_quantize_dequantize_match_reference(q_type, shape):
    v = _data(1, shape)
    r, p = _trained(q_type, v)
    rq, pq = r.quantize(v), p.quantize(v)
    np.testing.assert_array_equal(_bits(pq), _bits(rq))
    assert tuple(pq.shape) == tuple(np.asarray(rq).shape)
    np.testing.assert_array_equal(p.dequantize(pq), r.dequantize(rq))
    assert p.dequantize(pq).dtype == np.float32
    assert p.type().value == r.type().value == q_type
    assert p.is_trained() and r.is_trained()


def test_int8_state_errors_and_hooks():
    v = _data(2)
    p, r = port.Int8Quantizer(), ref.Int8Quantizer()
    assert not p.is_trained()
    with pytest.raises(port.NotTrainedQuantizerError):
        p.quantize(v)
    with pytest.raises(port.NotTrainedQuantizerError):
        p.dequantize(np.zeros(3, np.int8))
    p.train(v)
    r.train(v)
    assert p.get_abs_max() == r.get_abs_max() == float(np.abs(v).max())
    p.set_abs_max(3.0)
    r.set_abs_max(3.0)
    np.testing.assert_array_equal(p.quantize(v), r.quantize(v))   # clipped to +-127
    assert np.abs(p.quantize(v)).max() == 127
    p.train(np.zeros((0, 4), np.float32))
    assert not p.is_trained()


def test_factory_and_exports():
    assert isinstance(port.new_quantizer(port.QuantizerType.INT8), port.Int8Quantizer)
    assert comet_tpu_torch.new_quantizer is port.new_quantizer
    for name in ("FullPrecisionQuantizer", "HalfPrecisionQuantizer", "BFloat16Quantizer",
                 "Int8Quantizer", "QuantizerType", "NotTrainedQuantizerError"):
        assert getattr(comet_tpu_torch, name) is getattr(port, name)
    with pytest.raises(ValueError):
        port.new_quantizer("int4")
    assert issubclass(port.NotTrainedQuantizerError, comet_tpu_torch.CometError)
    assert InvalidConfigError is comet_tpu_torch.InvalidConfigError


def test_bfloat16_rounds_to_nearest_even():
    """Values halfway between two bf16 neighbours round to the even one, as
    ml_dtypes does."""
    v = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8)], np.float32)
    got = port.BFloat16Quantizer().quantize(v)
    want = ref.BFloat16Quantizer().quantize(v)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(port.BFloat16Quantizer().dequantize(got),
                                  np.array([1.0, 1.015625, -1.0], np.float32))
