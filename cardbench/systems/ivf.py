"""The system under test for an IVF configuration: comet_tpu_torch's
IVFIndex (L2, float32 storage, `nlist` lists) trained by its own k-means
(`kmeans_iters` iterations) on the corpus's first `train_rows` rows, then
the whole corpus added with ids 1..n. The index takes the route a user's
index takes: no environment variable or routing switch is set.

After training, a host float32 copy of the index's learned centroids goes
into `data["centroids"]`: the deployment's learned parameters, which the
plain reference (references/ivf_l2.py) and the roofline stage
(work/ivf_scan.py) start from, as a model's weights would be handed over.

Entries:
    search_batch  index.search_batch(queries [B, d], k, nprobes=nprobe):
                  rows of ids and scores, (squared distance, id) ascending
    fluent        index.new_search().with_query(q).with_nprobes(nprobe)
                  .with_k(k).execute(): one list of results, (score, id)
                  ascending
"""

import numpy as np

INVALID_ID = 0xFFFFFFFF   # an empty result place of a batch row


class System:
    def __init__(self, config, data, device):
        from comet_tpu_torch import DistanceKind, IVFIndex

        corpus = data["corpus_host"]
        self.index = IVFIndex(config["dim"], config["nlist"], DistanceKind.L2, device=device)
        self.index.train(corpus[:config["train_rows"]], max_iter=config["kmeans_iters"])
        data["centroids"] = np.array(self.index._centroids, dtype=np.float32, copy=True)
        self.index.add_batch(corpus, ids=np.arange(1, config["n"] + 1, dtype=np.uint32))
        self.nprobe = config["nprobe"]
        self.pool = data["pool_host"]

    def spans(self):
        """(object, attribute, span) of the calls the traced run times: a
        search's coarse stage, scan and selects are launched inside
        `_search_launch`; an overflow's rescans inside `_launch_sparse`,
        which `_search_collect` calls (a first scan's `_launch_sparse` runs
        inside `_search_launch`, so each launch falls in one span)."""
        return [(self.index, "_search_launch", "stage.ivf_scan"),
                (self.index, "_launch_sparse", "stage.ivf_scan")]

    def batch(self, reqs, lo, hi, k):
        return self.index.search_batch(self.pool[reqs.rows[lo:hi]], k=k, nprobes=self.nprobe)

    def one(self, reqs, i, k):
        return (self.index.new_search().with_query(self.pool[reqs.rows[i]])
                .with_nprobes(self.nprobe).with_k(k).execute())

    @staticmethod
    def batch_row(out, j):
        ids, scores = out
        keep = ids[j] != INVALID_ID      # probed lists with fewer than k rows
        return ids[j][keep].astype(np.int64), scores[j][keep].astype(np.float64)

    @staticmethod
    def one_row(out):
        return (np.array([r.get_id() for r in out], dtype=np.int64),
                np.array([r.get_score() for r in out], dtype=np.float64))

    def close(self):
        self.index = None
