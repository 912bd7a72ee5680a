"""SIFT-range vectors whose neighbours cross IVF lists as SIFT1M's do:
one Gaussian over a LATENT-dimensional subspace whose axis scales decay
as 1 / rank (a descriptor set's decaying principal spectrum), MEAN plus
a per-component spread of SPREAD, rounded and clipped to the integers
0..255 that SIFT's components are (about 15 % of them clip to 0).

No cluster structure is planted, so k-means lists cut the data where it
is continuous and a query's nearest rows straddle lists. The constants
were set on the card against the one number the source publishes for
this operating point: nlist 1000 trained on 100,000 rows, nprobe 10,
reads recall@100 0.885-0.909 against exact flat ids over three seeds
(SIFT1M: 0.892) and recall@10 0.949-0.959 (PERF.md, §4).

As with sift_like, every float32 squared L2 distance of two rows is an
integer below 2^24, so it is exact and ties are decidable. Made on
`device` with a torch.Generator seeded from `--seed`: the corpus (`n`
rows) and a pool of `pool` query rows, float32."""

import torch

from harness.spec import sub_seed

LATENT = 32
DECAY = 1.0
MEAN = 40.0
SPREAD = 48.0      # standard deviation of a component before clipping
CHUNK = 1 << 18    # rows drawn at once


def make(config, seed, device, data):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "sift_spectrum"))
    d = config["dim"]
    scale = torch.arange(1, LATENT + 1, dtype=torch.float32, device=device) ** -DECAY
    scale *= SPREAD / scale.pow(2).mean().sqrt()
    proj = torch.randn((LATENT, d), generator=g, device=device) / LATENT ** 0.5

    def sample(count):
        out = torch.empty((count, d), dtype=torch.float32, device=device)
        for r0 in range(0, count, CHUNK):
            r1 = min(count, r0 + CHUNK)
            z = torch.randn((r1 - r0, LATENT), generator=g, device=device) * scale
            out[r0:r1] = (MEAN + z @ proj).round_().clamp_(0.0, 255.0)
        return out

    data["corpus"] = sample(config["n"])
    data["pool"] = sample(config["pool"])
