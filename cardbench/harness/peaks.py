"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time a piece of work could take on it:
chip_smoke.py's `bound`, copied so that the yardstick stays put."""

PEAK_FP32 = 67e12      # float32 operations/s outside the tensor cores (exact paths run no TF32)
PEAK_BYTES = 3.35e12   # device memory bytes/s


def least_seconds(n_ops: float, n_bytes: float, peak_ops: float = PEAK_FP32) -> float:
    """The larger of the operations at the peak rate and the bytes at the
    peak bandwidth."""
    return max(n_ops / peak_ops, n_bytes / PEAK_BYTES)

