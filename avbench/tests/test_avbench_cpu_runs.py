"""Whole runs of the harness on the CPU at a tiny size (the port's plain
versions through `Decoder(device="cpu")`): a run with no card fails; a
cell, a configuration, a traffic mix and a metric can be added as files
and entries alone; the control and the planted faults come out not
correct."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from avbench import control, run
from avbench.spec import ROOT

from .helpers import tiny_spec


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = run.main(["--workload", "1080p8_intra", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_no_result_without_the_port(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark, the
    command fails and prints nothing."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "avbench"), tmp_path / "avbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    r = subprocess.run([sys.executable, "-m", "avbench.run", "--workload",
                        "1080p8_intra", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0 and r.stdout == ""


def _add_files(doc, here):
    """A new configuration, traffic mix, metric and cell, as new files and
    entries only."""
    cfg = json.load(open(os.path.join(here, "configs", "tiny.json")))
    cfg.update(name="tiny10", bpc=10)
    json.dump(cfg, open(os.path.join(here, "configs", "tiny10.json"), "w"))
    json.dump(dict(generator="still_picture", tools={"tx_mode_largest": True},
                   groups=2, pool_seed=2, warmup_seed=1, check_groups=1),
              open(os.path.join(here, "traffic", "intra_largest.json"), "w"))
    with open(os.path.join(here, "metrics", "units_sent.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.window.sent)\n")
    doc["configs"].append(dict(doc["configs"][0], name="tiny10",
                               file="avb/configs/tiny10.json"))
    doc["workloads"].append(dict(name="tiny10_largest", config="tiny10",
                                 traffic="intra_largest", chips=1, why="x"))
    doc["end_to_end"].append(dict(name="units_sent", unit="units",
                                  better="higher", bound=0.01,
                                  source="host_clock",
                                  workloads=["tiny10_largest"]))


def test_a_cell_added_as_files_runs(tmp_path):
    spec = tiny_spec(str(tmp_path), extra=_add_files)
    res = run.run_cell(spec, spec.cell("tiny10_largest"), 2**31 + 3, 1.0,
                       False, device="cpu", workers=1)
    assert res["correct"], res
    assert set(res["metrics"]) == {"decode_fps", "picture_latency_ms",
                                   "setup_s", "units_sent"}
    assert res["metrics"]["units_sent"]["value"] == res["attempted"]
    assert list(res)[-1] == "checks"


def _add_grain_cell(doc, here):
    """The grain cell kept for later (the gop3_grain traffic and the
    grain_ms reader are in the folder), added by entries alone."""
    doc["workloads"].append(dict(name="tiny_gop3_grain", config="tiny",
                                 traffic="gop3_grain", chips=1, why="x"))
    doc["per_layer"].append(dict(name="grain_ms", unit="ms/picture",
                                 better="lower", source="host_clock",
                                 layer="grain", moves="decode_fps",
                                 workloads=["tiny_gop3_grain"]))


def test_traced_run_reads_the_host_layers(tmp_path):
    spec = tiny_spec(str(tmp_path), extra=_add_grain_cell)
    res = run.run_cell(spec, spec.cell("tiny_gop3_grain"), 11, 2.0, True,
                       device="cpu", workers=1)
    assert res["correct"], res
    m = res["metrics"]
    for name in ("get_wait_ms", "syntax_ms", "plan_ms", "pack_ms",
                 "upload_ms", "gc_ms", "grain_ms"):
        assert m[name]["value"] >= 0, name
    # the device metrics come only from a card's trace
    assert "device_busy_ms" not in m and "kernels_roofline" not in m
    assert res["facts"]["frames"] >= 1 and res["facts"]["wave_levels"] > 0


class Faulty:
    """The port's CPU decoder with a fault planted where a picture is
    produced, from the window on (the warm-up's group of 3 pictures is
    left sound)."""

    WARM = 3

    def __init__(self, dec, fault, monkeypatch):
        self.dec, self.fault, self.n, self.prev = dec, fault, 0, None
        self.monkeypatch = monkeypatch

    def send_data(self, data, timestamp=0):
        if self.fault == "fallback" and self.n >= self.WARM:
            # the engine declines every frame: the host path decodes them
            # (right pictures, an idle card)
            from rav1d_tpu_torch.engine import plan

            self.monkeypatch.setattr(plan, "build_plan", lambda t, f: None)
        self.dec.send_data(data, timestamp)

    def get_picture(self):
        pic = self.dec.get_picture()
        self.n += 1
        on = self.n > self.WARM
        if on and self.fault == "unchanged" and self.prev is not None:
            # the picture's planes left as the last picture's
            pic.y, pic.u, pic.v = self.prev.y, self.prev.u, self.prev.v
        if on and self.fault == "altered" and self.n == self.WARM + 2:
            pic.y = pic.y.copy()
            pic.y[3, 5] ^= 1
        self.prev = pic
        if on and self.fault == "half" and self.n % 2 == 0:
            return self.get_picture()  # every second picture left out
        return pic

    def close(self):
        self.dec.close()


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered",
                                   "fallback"])
def test_planted_faults_fail(tmp_path, monkeypatch, fault):
    from rav1d_tpu_torch.decoder import Decoder

    spec = tiny_spec(str(tmp_path), check_groups=3)

    def make(settings, device):
        dec = Decoder(settings, device=device)
        return dec if fault is None else Faulty(dec, fault, monkeypatch)

    res = run.run_cell(spec, spec.cell("1080p8_gop3"), 5, 3.0, False,
                       device="cpu", make_decoder=make, workers=1)
    assert res["correct"] is (fault is None), res["checks"]
    if fault == "fallback":
        assert res["checks"]["fallback"]["value"] >= 1
        assert res["checks"]["mismatched"]["value"] == 0


def test_control_fails(tmp_path):
    spec = tiny_spec(str(tmp_path))
    cell = spec.cell("1080p8_intra")
    res = run.run_cell(spec, cell, 7, 1.0, False, device="cpu",
                       make_decoder=lambda s, d: control.ControlDecoder(s, 8),
                       workers=1)
    assert not res["correct"]
    assert res["checks"]["mismatched"]["value"] >= 1


def test_control_cuts_the_low_bits():
    from avbench import reference, streamgen

    dec = control.ControlDecoder(reference.Settings(), 10)
    dec.send_data(streamgen.still_picture(64, 64, 3, bpc=10))
    pic = dec.get_picture()
    assert not np.any(pic.y & 3) and pic.y.max() > 0
