"""Scalar storage quantizers: float32 / float16 / bfloat16 / int8.

Host copy of comet_tpu/ops/quantizer.py, with the same types, formats and
semantics. Numpy has no bfloat16, so `BFloat16Quantizer.quantize` returns
the rounded values as a torch.bfloat16 tensor on the CPU (round to nearest
even, the bits of the reference's ml_dtypes array) and `dequantize`
takes that or any array of the values.

Capability parity with the Go reference's quantizer module (quantizer.go:26-247):
full-precision pass-through, half-precision, and symmetric abs-max int8
(Map [-absMax, absMax] -> [-127, 127], quantizer.go:201-232). The reference
ships this module UNWIRED (no index uses it, SURVEY.md §2 #3); here it is
both standalone (this API) and the engine behind the flat index's optional
reduced-precision storage mode. bfloat16 is added because it is the TPU's
native reduced-precision format (same exponent range as float32).

Batched: all ops are vectorized numpy over [n, d] arrays; scalar [d]
vectors work too.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from comet_tpu_torch.types import CometError, InvalidConfigError


class QuantizerType(str, enum.Enum):
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT8 = "int8"


class NotTrainedQuantizerError(CometError):
    pass


class FullPrecisionQuantizer:
    """Identity storage (quantizer.go:81-110)."""

    def train(self, vectors) -> None:
        return None

    def is_trained(self) -> bool:
        return True

    def quantize(self, vector) -> np.ndarray:
        return np.asarray(vector, dtype=np.float32)

    def dequantize(self, stored) -> np.ndarray:
        return np.asarray(stored, dtype=np.float32)

    def type(self) -> QuantizerType:
        return QuantizerType.FLOAT32


class HalfPrecisionQuantizer:
    """IEEE float16 storage (quantizer.go:126-159)."""

    def train(self, vectors) -> None:
        return None

    def is_trained(self) -> bool:
        return True

    def quantize(self, vector) -> np.ndarray:
        return np.asarray(vector, dtype=np.float32).astype(np.float16)

    def dequantize(self, stored) -> np.ndarray:
        return np.asarray(stored, dtype=np.float16).astype(np.float32)

    def type(self) -> QuantizerType:
        return QuantizerType.FLOAT16


class BFloat16Quantizer:
    """bfloat16 storage — the TPU-native half format (extension)."""

    def train(self, vectors) -> None:
        return None

    def is_trained(self) -> bool:
        return True

    def quantize(self, vector) -> torch.Tensor:
        return torch.from_numpy(np.array(vector, dtype=np.float32)).to(torch.bfloat16)

    def dequantize(self, stored) -> np.ndarray:
        if isinstance(stored, torch.Tensor):
            return stored.to(torch.float32).numpy()
        return np.asarray(stored).astype(np.float32)

    def type(self) -> QuantizerType:
        return QuantizerType.BFLOAT16


class Int8Quantizer:
    """Symmetric abs-max int8 (quantizer.go:180-247)."""

    def __init__(self, abs_max: float = 0.0):
        self.abs_max = float(abs_max)

    def train(self, vectors) -> None:
        v = np.asarray(vectors, dtype=np.float32)
        self.abs_max = float(np.abs(v).max()) if v.size else 0.0

    def is_trained(self) -> bool:
        return self.abs_max > 0

    def quantize(self, vector) -> np.ndarray:
        if not self.is_trained():
            raise NotTrainedQuantizerError("quantizer must be trained before use")
        v = np.asarray(vector, dtype=np.float32)
        scaled = np.round(v / self.abs_max * 127.0)
        return np.clip(scaled, -127, 127).astype(np.int8)

    def dequantize(self, stored) -> np.ndarray:
        if not self.is_trained():
            raise NotTrainedQuantizerError(
                "quantizer must be trained before dequantization"
            )
        return np.asarray(stored, dtype=np.float32) / 127.0 * self.abs_max

    def type(self) -> QuantizerType:
        return QuantizerType.INT8

    # serialization hooks (quantizer.go:240-247)
    def get_abs_max(self) -> float:
        return self.abs_max

    def set_abs_max(self, abs_max: float) -> None:
        self.abs_max = float(abs_max)


def new_quantizer(q_type: QuantizerType | str):
    """Factory (quantizer.go:56-67)."""
    q_type = QuantizerType(q_type)
    if q_type == QuantizerType.FLOAT32:
        return FullPrecisionQuantizer()
    if q_type == QuantizerType.FLOAT16:
        return HalfPrecisionQuantizer()
    if q_type == QuantizerType.BFLOAT16:
        return BFloat16Quantizer()
    if q_type == QuantizerType.INT8:
        return Int8Quantizer()
    raise InvalidConfigError(f"unsupported quantizer type: {q_type}")
