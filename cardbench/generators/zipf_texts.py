"""Texts of `words_per_doc` words a document, each drawn Zipf(`zipf_s`)
over ranks 1..`vocab` (word index = rank mod vocab, as chip_smoke's
bm25_corpus folds numpy's zipf draws), from a letter-only vocabulary:
word i is four letters spelling i in base 26, then "x". Words are joined
by single spaces.

Made on `device` with a torch.Generator from `--seed`, by inverse CDF in
a few large calls: `data["tokens"]` is the [n, words_per_doc] int32 matrix
of word indices; `texts(data, r0, r1)` spells documents r0..r1-1 as
strings in one bulk decode."""

import numpy as np
import torch

from harness.spec import sub_seed

CHUNK = 1 << 17   # documents drawn or spelt at once
WORD_BYTES = 5    # four letters and "x"


def word(i: int) -> str:
    return "".join(chr(97 + (i // 26 ** j) % 26) for j in range(4)) + "x"


def vocabulary(size: int) -> list[str]:
    return [word(i) for i in range(size)]


def make(config, seed, device, data):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "zipf_texts"))
    v, w, n = config["vocab"], config["words_per_doc"], config["n"]
    ranks = torch.arange(1, v + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** -config["zipf_s"], 0)
    cdf /= cdf[-1].clone()
    tokens = torch.empty((n, w), dtype=torch.int32, device=device)
    for r0 in range(0, n, CHUNK):
        r1 = min(n, r0 + CHUNK)
        u = torch.rand(((r1 - r0) * w,), generator=g, device=device, dtype=torch.float64)
        rank = torch.searchsorted(cdf, u).clamp_(max=v - 1) + 1
        tokens[r0:r1] = (rank % v).view(r1 - r0, w).to(torch.int32)
    data["tokens"] = tokens
    table = np.frombuffer("".join(vocabulary(v)).encode("ascii"), np.uint8)
    data["word_bytes"] = torch.from_numpy(table.reshape(v, WORD_BYTES).copy()).to(device)


def texts(data, r0: int, r1: int) -> list[str]:
    """Documents r0..r1-1 as strings: words joined by single spaces."""
    tokens, table = data["tokens"], data["word_bytes"]
    out: list[str] = []
    for c0 in range(r0, r1, CHUNK):
        c1 = min(r1, c0 + CHUNK)
        t = tokens[c0:c1].long()
        buf = torch.full((c1 - c0, t.shape[1], WORD_BYTES + 1), ord(" "),
                         dtype=torch.uint8, device=t.device)
        buf[:, :, :WORD_BYTES] = table[t]
        buf[:, -1, WORD_BYTES] = ord("\n")
        out += buf.cpu().numpy().tobytes().decode("ascii").split("\n")[:-1]
    return out
