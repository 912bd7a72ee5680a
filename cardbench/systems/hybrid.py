"""The system under test for a hybrid configuration: comet_tpu_torch's
HybridSearchIndex over a FlatIndex (L2, float32), a BM25SearchIndex and a
RoaringMetadataIndex, document ids 1..n; document i + 1 has the vector
corpus[i], the text texts[i] and the metadata cat = categories[i mod
len(categories)], num = i mod num_mod.

Entry (reciprocal-rank fusion, one `eq("cat", c)` pre-filter a request):
    fluent        hybrid.new_search().with_vector(v).with_text(t)
                  .with_metadata(eq("cat", c)).with_fusion_kind(RRF)
                  .with_k(k).execute(): one fused list
"""

import numpy as np

from harness.spec import load_module

INGEST_DOCS = 1 << 17   # documents spelt and handed to BM25 at once


class System:
    def __init__(self, config, data, device):
        import comet_tpu_torch as ct

        self.ct = ct
        n = config["n"]
        ids = np.arange(1, n + 1, dtype=np.uint32)
        self.flat = ct.FlatIndex(config["dim"], ct.DistanceKind.L2, device=device)
        self.flat.add_batch(data["corpus_host"], ids=ids)
        self.text = ct.BM25SearchIndex(device=device)
        spell = load_module("generators", "zipf_texts").texts
        for r0 in range(0, n, INGEST_DOCS):
            r1 = min(n, r0 + INGEST_DOCS)
            self.text.add_batch(ids[r0:r1].tolist(), spell(data, r0, r1))
        self.meta = ct.RoaringMetadataIndex()
        cats = np.asarray(config["categories"])
        self.meta.add_columns(ids, {"cat": cats[np.arange(n) % len(cats)],
                                    "num": np.arange(n) % config["num_mod"]})
        self.hybrid = ct.new_hybrid_search_index(self.flat, self.text, self.meta)
        self.categories = config["categories"]
        self.pool = data["pool_host"]
        self.rrf = ct.FusionKind.RECIPROCAL_RANK

    def spans(self):
        """(object, attribute, span) of the calls the traced run times."""
        import comet_tpu_torch.fusion as fusion

        return [(self.flat, "_search_launch", "stage.scan"),
                (self.text, "_score", "stage.text"),
                (self.meta, "filter_bitset", "layer.filter"),
                (self.text, "new_search", "builder.text"),
                (fusion.Fusion, "combine", "layer.fusion")]

    def one(self, reqs, i, k):
        cat = self.ct.eq("cat", self.categories[int(reqs.cats[i])])
        return (self.hybrid.new_search().with_vector(self.pool[reqs.rows[i]])
                .with_text(reqs.texts[i]).with_metadata(cat)
                .with_fusion_kind(self.rrf).with_k(k).execute())

    @staticmethod
    def one_row(out):
        return (np.array([r.id for r in out], dtype=np.int64),
                np.array([r.score for r in out], dtype=np.float64))

    def close(self):
        self.hybrid = self.flat = self.text = self.meta = None
