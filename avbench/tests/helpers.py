"""A small copy of the benchmark for CPU runs: BENCHMARK.json naming a
tiny configuration, with the traffic mixes and metric readers copied."""

from __future__ import annotations

import json
import os
import shutil

from avbench.spec import HERE, ROOT, Spec


def tiny_spec(tmp, width=256, height=144, groups=3, check_groups=2,
              extra=None):
    """A Spec over a copy in `tmp` whose cells take the 1080p cells'
    traffic at `width` x `height`; `extra(doc, here)` may add files and
    entries to the copy before it is read."""
    here = os.path.join(tmp, "avb")
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(here, sub))
    os.makedirs(os.path.join(here, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        doc = json.load(fh)
    with open(os.path.join(HERE, "configs", "av1_1080p8_420.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny", width=width, height=height)
    with open(os.path.join(here, "configs", "tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    for name in os.listdir(os.path.join(here, "traffic")):
        p = os.path.join(here, "traffic", name)
        with open(p) as fh:
            tr = json.load(fh)
        tr.update(groups=groups, check_groups=check_groups)
        with open(p, "w") as fh:
            json.dump(tr, fh)
    doc["configs"] = [dict(doc["configs"][0], name="tiny",
                           file="avb/configs/tiny.json")]
    doc["workloads"] = [dict(w, config="tiny") for w in doc["workloads"]
                        if w["config"] == "av1_1080p8_420"]
    if extra is not None:
        extra(doc, here)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(doc, fh)
    return Spec(root=tmp, here=here)
