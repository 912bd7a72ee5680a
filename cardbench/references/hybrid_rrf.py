"""Plain reference of hybrid search: a metadata pre-filter, an exact L2
vector leg, a BM25 text leg and reciprocal-rank fusion, in PyTorch and
Python float64, worked out from the vectors, word matrix and categories
the benchmark made. Nothing of the program is imported or read.

Semantics (comet's hybrid search, as the configuration states them):
- filter: document i + 1 has category i mod C; only that category's
  documents take part in either leg;
- vector leg: the k nearest allowed documents by (squared distance, id),
  scored by the float32 L2 distance (flat_l2.py);
- text leg: BM25 with K1 = 1.2, B = 0.75 over every segment of the text:
  a document's tokens are its W words and the W - 1 single spaces between
  them, a query's the same; idf = ln((N - df + 0.5) / (df + 0.5) + 1),
  N = all documents, avgdl = tokens / N; each query token adds
  idf * tf (K1 + 1) / (tf + K1 (1 - B + B dl / avgdl)), repeats included;
  the k best allowed documents with a score above 0, by (score desc, id);
- fusion: rank r (0-based) in a leg gives 1 / (60 + r); a leg ranks by
  (score, id), distances ascending and BM25 descending; the fused score is
  the vector leg's term plus the text leg's, in that order, in float64;
  the k best by (fused desc, id); where the text leg found nothing, the
  vector leg's list stands, distances ascending.

BM25 is computed in float64; the program's float32 sum may order two
documents whose scores differ by rounding either way, and two documents
whose words differ but whose float64 scores are equal (words of the same
df at other places of the query) differ in float32 by where the word's
term falls in the sum. Documents with the same term frequencies get the
same score in any sum of fixed order, and their ties break by id. So a
request is decided only where no document of its k best lies within a
relative REL_TOL of the score (equal included) of an allowed document
with other term frequencies. `precision="control"` is
the comparison's control: BM25 in bfloat16 (the precision below the
configuration's float32) and the distances in TF32 (flat_l2.py)."""

import math
import re

import numpy as np
import torch

from harness.spec import load_module

K1, B = 1.2, 0.75
RRF_K = 60.0
REL_TOL = 1e-5
SPACE = -1
PATTERN_BASE = 1 << 8     # term frequencies of a document stay below 256
TOKEN = re.compile(r"[a-z]+| ")

flat_l2 = load_module("references", "flat_l2")


def query_tokens(text: str, index_of: dict) -> list[int]:
    """The query's segments in order: words as their vocabulary index,
    single spaces as SPACE; a word the vocabulary lacks is dropped."""
    out = []
    for seg in TOKEN.findall(text.lower()):
        if seg == " ":
            out.append(SPACE)
        elif seg in index_of:
            out.append(index_of[seg])
    return out


class TextLeg:
    def __init__(self, tokens: torch.Tensor, precision: str):
        self.tokens = tokens
        self.n, self.w = tokens.shape
        self.dl = float(2 * self.w - 1)
        self.precision = precision
        self._tf: dict[int, torch.Tensor] = {}

    def tf(self, term: int) -> torch.Tensor:
        if term not in self._tf:
            if term == SPACE:
                t = torch.full((self.n,), self.w - 1, dtype=torch.float64,
                               device=self.tokens.device)
            else:
                t = (self.tokens == term).sum(1).to(torch.float64)
            self._tf[term] = t
        return self._tf[term]

    def scores(self, terms: list[int]):
        """(BM25 score of every document, an id of each document's term
        frequencies over the query's distinct words)."""
        n, avgdl = float(self.n), self.dl
        dtype = torch.bfloat16 if self.precision == "control" else torch.float64
        s = torch.zeros(self.n, dtype=dtype, device=self.tokens.device)
        pattern = torch.zeros(self.n, dtype=torch.int64, device=self.tokens.device)
        for t in dict.fromkeys(t for t in terms if t != SPACE):
            pattern = pattern * PATTERN_BASE + self.tf(t).to(torch.int64)
        for t in terms:
            tf = self.tf(t)
            df = float((tf > 0).sum())
            if df == 0:
                continue
            idf = math.log((n - df + 0.5) / (df + 0.5) + 1.0)
            part = idf * (tf * (K1 + 1.0)) / (tf + K1 * (1.0 - B + B * (self.dl / avgdl)))
            s += torch.where(tf > 0, part, torch.zeros_like(part)).to(dtype)
        return s.to(torch.float64), pattern


def text_top(scores: torch.Tensor, pattern: torch.Tensor, allowed: torch.Tensor, k: int):
    """(ids, scores) of the k best allowed documents with a score above 0,
    by (score desc, id), and whether that order is decided: no document
    of the k best has a score within REL_TOL (equal included) of an allowed
    document with other term frequencies."""
    s = torch.where(allowed & (scores > 0), scores, torch.zeros_like(scores))
    live = s > 0
    if not bool(live.any()):
        return np.zeros(0, np.int64), np.zeros(0), True
    kth = torch.topk(s, min(k, int(live.sum())), sorted=True).values[-1]
    cand = torch.nonzero(s >= kth).flatten()   # the k-th's ties too: order them by id
    ci, cs = cand.cpu().numpy(), s[cand].cpu().numpy()
    o = np.lexsort((ci, -cs))[:k]
    ids, sc = ci[o] + 1, cs[o]
    decided = True
    for v in np.unique(sc):
        near = live & ((s - v).abs() <= REL_TOL * v)
        if torch.unique(pattern[near]).numel() > 1:
            decided = False
    return ids.astype(np.int64), sc, decided


def rrf_ranks(ids, scores, ascending: bool) -> dict:
    key = scores if ascending else -scores
    o = np.lexsort((ids, key))
    return {int(ids[j]): r for r, j in enumerate(o)}


def fuse(v_ids, v_scores, t_ids, t_scores, k: int):
    """(ids, scores, decided) of the fused list. With one leg empty the
    other's list stands alone, scored as that leg scores (vector-only:
    distances ascending); a text-only list carries float32 BM25 scores the
    float64 reference does not hold, so it is not decided."""
    if len(v_ids) and not len(t_ids):
        o = np.lexsort((v_ids, v_scores))[:k]
        return v_ids[o], v_scores[o], True
    if len(t_ids) and not len(v_ids):
        return t_ids, t_scores, False
    combined: dict[int, float] = {}
    for doc, r in rrf_ranks(v_ids, v_scores, True).items():
        combined[doc] = 1.0 / (RRF_K + r)
    for doc, r in rrf_ranks(t_ids, t_scores, False).items():
        combined[doc] = combined.get(doc, 0.0) + 1.0 / (RRF_K + r)
    items = sorted(combined.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
    return (np.array([i for i, _ in items], dtype=np.int64),
            np.array([s for _, s in items], dtype=np.float64), True)


def expected(cell, data, reqs, picks, cats, precision="exact"):
    """(ids, scores, decided) of each request in `picks`; cats[j] is the
    category index of picks[j]."""
    config, k = cell["config_spec"], cell["traffic_spec"]["k"]
    n_cats = len(config["categories"])
    index_of = {w: i for i, w in enumerate(load_module("generators", "zipf_texts")
                                           .vocabulary(config["vocab"]))}
    corpus, dev = data["corpus"], data["corpus"].device
    slots = torch.arange(corpus.shape[0], device=dev)
    cats_dev = torch.as_tensor(np.asarray(cats, dtype=np.int64), device=dev)

    def allowed(q0, q1):
        return (slots[None, :] % n_cats) == cats_dev[q0:q1, None]

    queries = data["pool"][torch.as_tensor(reqs.rows[picks], device=dev)]
    v_ids, v_d2 = flat_l2.knn(corpus, queries, k, allowed, precision)
    vec = flat_l2.rows(v_ids, v_d2, "score")
    leg = TextLeg(data["tokens"], precision)
    out = []
    for j, p in enumerate(picks):
        ok = (slots % n_cats) == int(cats[j])
        score, pattern = leg.scores(query_tokens(reqs.texts[p], index_of))
        t_ids, t_sc, decided = text_top(score, pattern, ok, k)
        f_ids, f_sc, whole = fuse(vec[j][0], vec[j][1], t_ids, t_sc, k)
        out.append((f_ids, f_sc, decided and whole))
    return out
