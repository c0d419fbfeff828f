"""Drive rav1d_tpu_torch's intra path once on a CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
1. set-up: build the hand-written itx kernel (csrc/itx.cu, nvcc, sm_90a);
2. kernel: the kernel against its plain torch version on the card, all
   nine tx classes x bpc 8/10/12, N=1000 random int32 blocks including
   extreme values; bit-identical required;
3. slice: decode seeded 1920x1080 synthetic AV1 still pictures
   (rav1d_tpu_torch/synth.py) through rav1d_tpu_torch.Decoder(device="cuda")
   and hold each to the rav1d_tpu host path's MD5 on the same bytes; every
   frame on the engine, no fallback, the itx kernel launched;
4. timing: the kernel and its plain version at the main path's per-class
   block counts, bit-identical there too;
5. vectors: where $RAV1D_TEST_DATA names a dav1d-test-data directory,
   two conformance streams against their meson MD5s.

Prints the card's name and power limit, the syntax backend, per-frame
stage times (CUDA events), the host path's time on the same frames, a
JSON line describing each kernel, and as its last line
{"ok": true, "device": {...}}. There is no CPU path.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SEEDS = (1, 2)
W, H = 1920, 1080
VECTORS = [
    ("8-bit/issues/324_tennis.ivf", "53a0ba36b3a3656e6a12efb358d71f9e"),
    ("8-bit/issues/320_tennis.ivf", "86e9c91b80bb738693c3781e728fd7f5"),
]


def log(*a):
    print(*a, flush=True)


def gpu_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_inputs(w, h, bpc, n, seed, dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cmax = (1 << (bpc + 7)) - 1
    cb = rng.integers(-cmax, cmax, size=(n, h, w), dtype=np.int64)
    cb[: n // 8] = rng.integers(-(2**31), 2**31 - 1, size=(n // 8, h, w))
    cb = cb.astype(np.int32)
    f = rng.integers(0, 4, size=n).astype(np.int32)
    s = rng.integers(0, 4, size=n).astype(np.int32)
    return [torch.from_numpy(a).to(dev) for a in (cb, f, s)]


def kernel_phase(dev):
    """Kernel vs plain version, every class x bitdepth. Returns max |err|."""
    import torch

    from rav1d_tpu_torch.engine.kernels import itx_any_core
    from rav1d_tpu_torch.engine.layout import KERNEL_SIZES
    from rav1d_tpu_torch.ops.cuda import itx as I

    worst = 0
    for w, h in sorted(KERNEL_SIZES):
        for bpc in (8, 10, 12):
            args = kernel_inputs(w, h, bpc, 1000, w * 100 + h * 7 + bpc, dev)
            got = I.itx(*args, w, h, bpc)
            ref = itx_any_core(*args, w, h, bpc)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, ref):
                raise AssertionError(f"itx kernel != plain at {w}x{h} bpc {bpc}")
    log("kernel phase: itx kernel bit-identical to its plain version on "
        "9 classes x bpc 8/10/12 (N=1000)")
    return worst


def host_decode(data):
    import rav1d_tpu
    from rav1d_tpu_torch import synth

    t0 = time.perf_counter()
    md5 = synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False)), [data])
    return md5, (time.perf_counter() - t0) * 1e3


def slice_phase(dev):
    """The main path: synthetic 1080p pictures through the port."""
    import rav1d_tpu
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import run
    from rav1d_tpu_torch.ops.cuda import itx as I

    streams = [synth.still_picture(W, H, s) for s in SEEDS]
    oracle = []
    feats = []
    for s, data in zip(SEEDS, streams):
        md5, ms = host_decode(data)
        oracle.append(md5)
        log(f"host path seed {s} {W}x{H}: {ms:.1f} ms  md5 {md5[0]}")
        (fp,) = synth.capture_frames([data])
        feats.append(synth.features(*fp))
        log("  features " + json.dumps(feats[-1]))

    # warm-up (CUDA context, lazy module loads) on a small picture
    synth.decode_md5s(T.Decoder(rav1d_tpu.Settings(apply_grain=False),
                                device=dev), [synth.still_picture(256, 128, 7)])
    torch.cuda.synchronize()

    T.engine.stats.update(frames=0, fallback=0)
    I.launches = 0
    got = []
    wall = []
    stages = []
    for data in streams:  # one frame each: stage_ms is per frame
        run.reset_stats()
        t0 = time.perf_counter()
        got.append(synth.decode_md5s(
            T.Decoder(rav1d_tpu.Settings(apply_grain=False), device=dev), [data]))
        wall.append((time.perf_counter() - t0) * 1e3)
        stages.append(dict(run.stage_ms))
    launches = I.launches
    stats = dict(T.engine.stats)

    for s, st, ms, g, o in zip(SEEDS, stages, wall, got, oracle):
        log(f"port seed {s} {W}x{H}: {ms:.1f} ms wall  md5 {g[0]}  "
            f"{'==' if g == o else '!='} host")
        log("  stage_ms " + json.dumps({k: round(v, 3) for k, v in st.items()}))
    log(f"engine stats {stats}  itx launches {launches}")
    if got != oracle:
        raise AssertionError("port output differs from the host path")
    if stats["frames"] != len(streams) or stats["fallback"] != 0:
        raise AssertionError(f"engine did not decode every frame: {stats}")
    if launches <= 0:
        raise AssertionError("the itx kernel was not launched on the main path")
    return launches, feats


def timing_phase(dev, feats):
    """Kernel and plain version at the main path's block counts (the
    largest per-class count of the slice's frames), summed over classes;
    the two outputs at those shapes must be bit-identical too. Returns
    (kernel ms, plain ms, max |err|)."""
    import torch

    from rav1d_tpu_torch.engine.kernels import itx_any_core
    from rav1d_tpu_torch.ops.cuda import itx as I

    lanes = {}
    for ft in feats:
        for k, n in ft["tx_lanes"].items():
            lanes[k] = max(lanes.get(k, 0), n)
    tk = tp = 0.0
    worst = 0
    for key in sorted(lanes, key=lambda k: tuple(map(int, k.split("x")))):
        w, h = map(int, key.split("x"))
        if (w, h) not in I.KERNEL_SIZES:
            continue
        n = lanes[key]
        args = kernel_inputs(w, h, 8, n, n, dev)
        got = I.itx(*args, w, h, 8)
        ref = itx_any_core(*args, w, h, 8)
        worst = max(worst, int((got.to(torch.int64) - ref.to(torch.int64))
                               .abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"itx kernel != plain at {key} N={n}")
        k_ms = cuda_ms(lambda: I.itx(*args, w, h, 8), 20)
        p_ms = cuda_ms(lambda: itx_any_core(*args, w, h, 8), 5)
        tk += k_ms
        tp += p_ms
        log(f"itx {key:>5} N={n:6d}: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms")
    log(f"itx per frame (all classes): kernel {tk:.4f} ms  plain {tp:.4f} ms"
        " (outputs bit-identical at these N)")
    return tk, tp, worst


def vector_phase(dev):
    import rav1d_tpu

    import rav1d_tpu_torch as T
    from rav1d_tpu.io.ivf import IvfDemuxer

    d = os.environ.get("RAV1D_TEST_DATA")
    if not d or not os.path.isdir(d):
        log("vector phase: dav1d-test-data not found ($RAV1D_TEST_DATA "
            "unset or not a directory); skipped")
        return
    for rel, want in VECTORS:
        path = os.path.join(d, rel)
        if not os.path.exists(path):
            log(f"vector phase: {rel} not found; skipped")
            continue
        before = dict(T.engine.stats)
        dec = T.Decoder(rav1d_tpu.Settings(apply_grain=False), device=dev)
        m = hashlib.md5()
        for pkt in IvfDemuxer(path):
            dec.send_data(pkt.data, pkt.timestamp)
            while True:
                try:
                    pic = dec.get_picture()
                except rav1d_tpu.EAgain:
                    break
                for rows in pic.iter_plane_rows():
                    m.update(rows)
        fb = T.engine.stats["fallback"] - before["fallback"]
        log(f"vector {rel}: md5 {m.hexdigest()} (meson {want}) fallback {fb}")
        if m.hexdigest() != want:
            raise AssertionError(f"{rel}: md5 mismatch")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    import rav1d_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rav1d_tpu.native import syntax as native_syntax
    from rav1d_tpu_torch.ops.cuda import itx as I

    dev = torch.device("cuda")
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("syntax backend: " + ("native C (native/libsyntaxfull.so)"
                              if native_syntax.enabled() else "Python anchor"))

    t0 = time.perf_counter()
    I.lib()
    log(f"set-up: itx kernel built and loaded in {time.perf_counter() - t0:.1f} s")

    worst = kernel_phase(dev)
    launches, feats = slice_phase(dev)
    k_ms, p_ms, worst_main = timing_phase(dev, feats)
    worst = max(worst, worst_main)
    vector_phase(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    log(json.dumps({"kernels": [{
        "name": "itx",
        "route": "cuda",
        "source": "rav1d_tpu_torch/csrc/itx.cu",
        "replaces": "rav1d_tpu/ops/pallas/itx_all.py:110",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
