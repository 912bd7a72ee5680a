"""The system under test for a flat configuration: comet_tpu_torch's
FlatIndex (L2, float32 storage) over the generated corpus, ids 1..n.

Entries:
    search_batch  index.search_batch(queries [B, d], k): rows of ids and
                  scores, (squared distance, id) ascending
    fluent        index.new_search().with_query(q).with_k(k).execute():
                  one list of results, (score, id) ascending
"""

import numpy as np


class System:
    def __init__(self, config, data, device):
        from comet_tpu_torch import DistanceKind, FlatIndex

        self.index = FlatIndex(config["dim"], DistanceKind.L2, device=device)
        self.index.add_batch(data["corpus_host"],
                             ids=np.arange(1, config["n"] + 1, dtype=np.uint32))
        self.pool = data["pool_host"]

    def spans(self):
        """(object, attribute, span) of the calls the traced run times:
        the vector leg's scan and select are launched inside
        `_search_launch`."""
        return [(self.index, "_search_launch", "stage.scan")]

    def batch(self, reqs, lo, hi, k):
        return self.index.search_batch(self.pool[reqs.rows[lo:hi]], k=k)

    def one(self, reqs, i, k):
        return self.index.new_search().with_query(self.pool[reqs.rows[i]]).with_k(k).execute()

    @staticmethod
    def batch_row(out, j):
        ids, scores = out
        return ids[j].astype(np.int64), scores[j].astype(np.float64)

    @staticmethod
    def one_row(out):
        return (np.array([r.get_id() for r in out], dtype=np.int64),
                np.array([r.get_score() for r in out], dtype=np.float64))

    def close(self):
        self.index = None
