"""One run of one cell: `python -m avbench.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`, from the root of a checkout.

Set-up (timed as `setup_s`, from the start of this module): the cell's
stream written from the seed and held as bytes, the port imported, the
decoder made on the first CUDA card with the configuration's settings,
its kernels built or loaded and its shapes warmed up by one group that
is the same for every seed, and one full collection. Nothing is frozen
out of the collector: the decoder's collections walk the port's and
torch's long-lived objects as they would in a player's process (the
harness adds a few hundred objects of its own; the streams are bytes,
which the collector does not track). Then the window (window.py), the
check (check.py), and one JSON line on standard output. With `--trace 0` the line holds the cell's end-to-end metrics;
with `--trace 1` the layers are timed (spans.py, trace.py) and it holds
the per-layer metrics. A run with no CUDA card, or fewer than the cell
asks for, prints no result and exits 2; a run that finds JAX or the JAX
package loaded once the window has closed exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from . import check, roofline, streams, trace, window  # noqa: E402
from .spans import Tracer  # noqa: E402
from .spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rav1d_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port may not load,
    compared whole (rav1d_tpu_torch is not rav1d_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def decode_all(dec, units, eagain):
    """Decode `units` in the window's loop and drain the decoder: every
    picture taken and dropped."""
    feed = window.Feed(units)
    win = window.Window()
    while feed.next < len(units) or feed.held is not None:
        feed.send(dec, eagain, time.perf_counter, win, None)
        try:
            feed.sent_at.pop(dec.get_picture().timestamp)
        except eagain:
            pass
    win.sent = feed.next
    window.drain(dec, win, feed, eagain)
    if win.errors or feed.sent_at:
        raise RuntimeError(f"warm-up failed: {win.errors or feed.sent_at}")


def power_limit():
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(spec, cell, seed, seconds, traced, device="cuda",
             make_decoder=None, t_start=T_START, workers=4,
             clock=time.perf_counter):
    """Set up, run the window, check, and read the metrics. Returns the
    result dict. `make_decoder(settings, device)` replaces the port's
    Decoder (the control and the fault tests)."""
    import torch
    from rav1d_tpu_torch import engine
    from rav1d_tpu_torch.decoder import Decoder, EAgain, Settings
    from rav1d_tpu_torch.engine import run as engine_run

    config, traffic = spec.config(cell), spec.traffic(cell)
    stream = streams.make(config, traffic, seed)
    warm = streams.warmup(config, traffic)
    settings = Settings(**config["settings"])
    cuda = torch.device(device).type == "cuda"
    dec = (make_decoder or (lambda s, d: Decoder(s, device=d)))(settings, device)
    decode_all(dec, warm, EAgain)
    if cuda:
        torch.cuda.synchronize()
    tracer = dtrace = None
    if traced:
        tracer = Tracer(clock)
        if cuda:
            trace.DeviceTrace.warm()
            dtrace = trace.DeviceTrace()
    gc.collect()
    before = SimpleNamespace(stage=dict(engine_run.stage_ms),
                             stats=dict(engine.stats))

    def on_open():
        if tracer is not None:
            tracer.install()
        if dtrace is not None:
            dtrace.start(clock)

    setup_s = clock() - t_start
    win, feed = window.drive(dec, stream.units, seconds, EAgain, clock=clock,
                             on_open=on_open,
                             span=None if tracer is None else tracer.add)
    stage = {k: engine_run.stage_ms[k] - before.stage[k] for k in before.stage}
    stats = {k: engine.stats[k] - before.stats[k] for k in before.stats}
    if dtrace is not None:
        dtrace.stop()
    if tracer is not None:
        tracer.uninstall()
    window.drain(dec, win, feed, EAgain, clock=clock)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    device_readings = None
    if dtrace is not None:
        device_readings = trace.reduce(dtrace.device_ops(), tracer.spans,
                                       roofline.Kernels(), win.t0, win.t1)
        dtrace = None
    dec.close()
    del dec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    power = power_limit() if cuda else None

    t_check = clock()
    got = dict(win.digests)
    got.update(win.late)
    checks = check.run(config, traffic, stream, win.sent, got, seed, workers,
                       fallback=stats["fallback"])
    check_s = clock() - t_check

    run = SimpleNamespace(
        cell=cell, config=config, traffic=traffic, window=win,
        setup_s=setup_s, tracer=tracer, device=device_readings, stage=stage,
        stats=stats, peak_bytes_per_s=roofline.peak_bytes_per_s(kind))
    metrics = {}
    for m in spec.metrics(cell, traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": checks.correct, "attempted": win.sent,
           "failed": checks.missing + checks.mismatched,
           "metrics": metrics, "device": dev}
    facts = {"pictures": win.pictures, "window_s": win.seconds,
             "setup_s": setup_s, "check_s": check_s,
             "groups_checked": list(checks.groups), "engine": stats,
             "power": power, "errors": dict(list(win.errors.items())[:5])}
    if device_readings is not None:
        dev["busy_s"] = device_readings["busy_s"]
        dev["window_s"] = device_readings["window_s"]
        out["breakdown"] = breakdown(device_readings)
    if tracer is not None:
        facts.update(frames=tracer.frames, wave_levels=tracer.waves,
                     inter_tiles=tracer.inter_tiles, grained=tracer.grained)
    out["facts"] = facts
    out["checks"] = checks.numbers()
    return out


def breakdown(d):
    """The ten device operations that took most time, and the idle time
    by what the host was doing."""
    ops = sorted(d["by_name"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(d["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [["idle:" + n, s] for n, s in idle]}


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m avbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"avbench: {cell['name']} needs {cell['chips']} CUDA device(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    res = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                   workers=min(4, os.cpu_count() or 1))
    found = forbidden_modules()
    if found:
        print(f"avbench: loaded after the window: {', '.join(found)}; "
              "no result", file=sys.stderr)
        return 3
    for name, v in res["facts"].items():
        print(f"fact {name}: {v}", file=sys.stderr)
    for name, v in res["checks"].items():
        print(f"check {name}: {v}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
