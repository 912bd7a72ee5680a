"""SIFT-range clustered vectors: a Gaussian mixture of 1024 centres with a
16-dimensional spread (bench.py's generator, as chip_smoke.sift_like
draws it), rounded and clipped to the integers 0..255 that SIFT's
components are. On such data every float32 squared L2 distance is an
integer below 2^24 (128 x 255^2 x 2 < 2^24), so it is exact and ties are
decidable.

Made on `device` with a torch.Generator seeded from `--seed`: the corpus
(`n` rows) and a pool of `pool` query rows, float32."""

import torch

from harness.spec import sub_seed

CENTRES = 1024
SPREAD_DIM = 16
SPREAD = 12.0
CHUNK = 1 << 18   # rows drawn at once


def make(config, seed, device, data):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "sift_like"))
    d = config["dim"]
    centres = torch.rand((CENTRES, d), generator=g, device=device) * 256.0
    proj = torch.randn((SPREAD_DIM, d), generator=g, device=device)

    def sample(count):
        out = torch.empty((count, d), dtype=torch.float32, device=device)
        for r0 in range(0, count, CHUNK):
            r1 = min(count, r0 + CHUNK)
            which = torch.randint(0, CENTRES, (r1 - r0,), generator=g, device=device)
            z = torch.randn((r1 - r0, SPREAD_DIM), generator=g, device=device) * SPREAD
            out[r0:r1] = (centres[which] + z @ proj).round_().clamp_(0.0, 255.0)
        return out

    data["corpus"] = sample(config["n"])
    data["pool"] = sample(config["pool"])
