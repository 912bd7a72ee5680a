"""The generators and the traffic repeat from a seed and give every seed
the same amount of work."""

import numpy as np
import pytest
import torch

from cardbench_tiny import tiny_cell
from harness import spec, traffic

BIG_SEED = 2 ** 31 + 12345


def make(cell, seed):
    data = {}
    for name in cell["config_spec"]["generators"]:
        spec.load_module("generators", name).make(cell["config_spec"], seed, "cpu", data)
    return data


@pytest.mark.parametrize("name", ["flat-batch2048", "hybrid-online-rrf"])
def test_data_repeats_from_the_seed_and_differs_between_seeds(name):
    cell = tiny_cell(name)
    a, b, c = make(cell, BIG_SEED), make(cell, BIG_SEED), make(cell, BIG_SEED + 1)
    for key in a:
        assert torch.equal(a[key], b[key])
    assert not torch.equal(a["corpus"], c["corpus"])
    x = a["corpus"]
    assert x.shape == (4096, 128) and x.dtype == torch.float32
    assert torch.equal(x, x.round()) and float(x.min()) >= 0 and float(x.max()) <= 255
    assert a["pool"].shape == (512, 128)


def test_texts_spell_the_word_matrix():
    cell = tiny_cell("hybrid-online-rrf")
    data = make(cell, 7)
    zt = spec.load_module("generators", "zipf_texts")
    vocab = zt.vocabulary(cell["config_spec"]["vocab"])
    texts = zt.texts(data, 0, 300)
    tokens = data["tokens"].numpy()
    assert len(texts) == 300
    for i in (0, 1, 150, 299):
        assert texts[i].split(" ") == [vocab[t] for t in tokens[i]]
    assert all(len(w) == 5 and w.isalpha() for w in vocab[:100])
    assert len(set(vocab)) == len(vocab)
    # Zipf: the most frequent words are the low ranks
    counts = np.bincount(tokens.ravel(), minlength=len(vocab))
    assert counts[1] > counts[10] > counts[1000]


@pytest.mark.parametrize("name", ["hybrid-online-rrf", "flat-online-k10"])
def test_requests_repeat_and_come_in_equal_shares(name):
    cell = tiny_cell(name)
    tr, cf = cell["traffic_spec"], cell["config_spec"]
    vocab = traffic.vocabulary(cf)
    a = traffic.requests(tr, cf, BIG_SEED, 300, "window", vocab)
    b = traffic.requests(tr, cf, BIG_SEED, 300, "window", vocab)
    assert np.array_equal(a.rows, b.rows) and a.texts == b.texts
    if a.words is not None:
        lens = np.bincount([len(w) for w in a.words])
        assert len({lens[c] for c in tr["term_counts"]}) == 1
        lo, hi = tr["term_ranks"]
        assert all(lo <= int(w) < hi for ws in a.words for w in ws)
        assert all(len(set(ws.tolist())) == len(ws) for ws in a.words)


def test_arrivals_have_a_fixed_count_in_the_window():
    for seed in (1, 2, BIG_SEED):
        due = traffic.arrivals(seed, 400.0, 0.0, 10.0, "window")
        assert len(due) == 4000
        assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < 10.0
    assert not np.array_equal(traffic.arrivals(1, 400.0, 0.0, 10.0, "w"),
                              traffic.arrivals(2, 400.0, 0.0, 10.0, "w"))


def test_sub_seeds_take_any_whole_number():
    seeds = {spec.sub_seed(s, "x") for s in (0, 1, 2 ** 31, 2 ** 40 + 3, -5)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 63 for s in seeds)
