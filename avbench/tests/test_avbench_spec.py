"""BENCHMARK.json against the contract's shape, and every name it holds
found as a file of its own."""

import json
import os
import re

import pytest

from avbench.spec import HERE, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

SPEC = Spec()
DOC = SPEC.doc


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["avbench"]
    assert DOC["command"][:3] == ["python3", "-m", "avbench.run"]
    assert 1 <= DOC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    cfg = SPEC.config(cell)
    assert cfg["name"] == cell["config"]
    assert SPEC.traffic(cell)["generator"] in ("inter_sequence", "still_picture")
    for traced in (False, True):
        for m in SPEC.metrics(cell, traced):
            assert callable(SPEC.reader(m["name"]))
    e2e = {m["name"] for m in SPEC.metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.metrics(cell, True)


def test_names_units_and_keys():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("avbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        keys = set(m) - {"workloads"}
        if m in DOC["end_to_end"]:
            assert keys == {"name", "unit", "better", "bound", "source"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert keys == {"name", "unit", "better", "source", "layer", "moves"}
            assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in DOC["end_to_end"]}


def test_every_file_under_the_folder_is_named_from_name_characters():
    for d, _, files in os.walk(HERE):
        if "__pycache__" in d or os.path.join("reference", "build") in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert all(NAME.match(part) for part in rel.split(os.sep)), rel
