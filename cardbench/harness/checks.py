"""The comparison that decides `correct`, its control, and the least
time of the roofline stages.

The program's results are held to the plain reference (references/)
on a sample drawn from the seed: in a closed loop KEEP_PER_CALL rows of
every call, of which `sample` are compared; in an open loop `sample` of
the window's requests. The number compared is the count of result places
(id and score, both exact) that differ from the reference's, over the
requests whose order the reference decides; its limit is 0. At least
MIN_CHECKED requests have to be decided, and no request may fail.
"""

from __future__ import annotations

import numpy as np

from harness import spec, traffic

MIN_CHECKED = 64


def mismatches(got, want):
    """(places that differ, requests compared, requests not decided)."""
    bad = checked = undecided = 0
    for (gi, gs), (wi, ws, decided) in zip(got, want):
        if not decided:
            undecided += 1
            continue
        checked += 1
        for p in range(max(len(gi), len(wi))):
            if p >= len(gi) or p >= len(wi) or gi[p] != wi[p] or gs[p] != ws[p]:
                bad += 1
    return bad, checked, undecided


def picks_of(cell, plan, kept):
    """(keys of `kept` compared, their request indices, their categories)."""
    tr = cell["traffic_spec"]
    keys = sorted(kept)
    if tr["loop"] == "closed":
        chosen = traffic.sample(plan.seed, len(keys), tr["sample"], "check")
        keys = [keys[i] for i in chosen]
        picks = [plan.batch_bounds(c)[0] + j for c, j in keys]
    else:
        picks = list(keys)
    return keys, np.asarray(picks, dtype=np.int64), categories(plan.reqs, picks)


def categories(reqs, picks):
    return [None if reqs.cats is None else reqs.cats[i] for i in picks]


def judge(cell, data, plan, kept, rec):
    keys, picks, cats = picks_of(cell, plan, kept)
    ref = spec.load_module("references", cell["config_spec"]["reference"])
    want = ref.expected(cell, data, plan.reqs, picks, cats, "exact") if len(picks) else []
    bad, checked, undecided = mismatches([kept[key] for key in keys], want)
    checks = {
        "mismatched_results": {"value": bad, "limit": 0, "rule": "at most"},
        "failed_requests": {"value": int(rec["failed"]), "limit": 0, "rule": "at most"},
        "checked_requests": {"value": checked, "limit": MIN_CHECKED, "rule": "at least"},
        "undecided_requests": {"value": undecided, "limit": None, "rule": "not compared"},
    }
    ok = bad == 0 and rec["failed"] == 0 and checked >= MIN_CHECKED
    return {"correct": bool(ok), "checks": checks}


def control(cell, seed, seconds, device):
    """The reference at the precision below the configuration's, put in
    the program's place on the requests a run would sample."""
    tr, cf = cell["traffic_spec"], cell["config_spec"]
    data = {}
    for name in cf["generators"]:
        spec.load_module("generators", name).make(cf, seed, device, data)
    plan = traffic.Plan(cell, seed, seconds)
    if tr["loop"] == "closed":
        picks = traffic.sample(seed, tr["requests"], tr["sample"], "control")
    else:
        picks = traffic.sample(seed, len(plan.due), tr["sample"], "window")
    cats = categories(plan.reqs, picks)
    ref = spec.load_module("references", cf["reference"])
    want = ref.expected(cell, data, plan.reqs, picks, cats, "exact")
    got = ref.expected(cell, data, plan.reqs, picks, cats, "control")
    bad, checked, undecided = mismatches([(i, s) for i, s, _ in got], want)
    return {"workload": cell["name"], "seed": seed, "control_mismatched_results": bad,
            "checked_requests": checked, "undecided_requests": undecided,
            "correct": bool(bad == 0 and checked >= MIN_CHECKED)}


def stage_work(cell, data, calls, stages):
    """Least seconds of each roofline stage over the traced calls, each
    (requests, lo, hi): work/<stage>.py counts the stage's work."""
    return {s: spec.load_module("work", s).seconds(cell, data, calls) for s in stages}
