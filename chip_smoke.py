"""Drive rav1d_tpu_torch's intra path once on a CUDA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
1. set-up: build the hand-written kernels (csrc/itx.cu: the itx kernel
   and the 8x8 DCT_DCT kernel; nvcc, sm_90a). The port's native syntax
   library (csrc/host/, built into rav1d_tpu_torch/build/ when the port is
   imported) must have loaded: a decode on the Python syntax anchor would
   change every host number;
2. kernel: the itx kernel against its plain torch version on the card,
   all nine tx classes x bpc 8/10/12, N=1000 random int32 blocks including
   extreme values; bit-identical required;
3. slice: decode seeded 1920x1080 synthetic AV1 still pictures
   (rav1d_tpu_torch/synth.py) through rav1d_tpu_torch.Decoder(device="cuda")
   and hold each to the committed host-path digest
   (rav1d_tpu_torch/smoke_digests.json) and to the port's own host path
   (Decoder(host_path=True)) on the same bytes; every frame on the engine,
   no fallback, the itx kernel launched;
4. timing: the itx kernel and its plain version at the main path's
   per-class block counts, bit-identical there too;
5. idct8x8: the 8x8 DCT_DCT batch (ops/itx8.py; on no decoder path): its
   entry point driven once at N=16384 with the launch count reset before
   and read after, then the kernel against idct8x8_batch_plain,
   bit-identical at N=256 for bpc 8/10/12 (1/8 of the blocks full-range
   int32) and at N=16384, where both are timed;
6. vectors: where $RAV1D_TEST_DATA names a dav1d-test-data directory,
   two conformance streams against their meson MD5s.
Then neither JAX nor any module of rav1d_tpu may have been imported.

Prints the card's name and power limit, the syntax backend, per-frame
stage times (CUDA events), the host path's time on the same frames, a
JSON line describing each kernel (its bound: the larger of the bytes it
must move over the H100's 3.35 TB/s and its 32-bit integer operations over
the card's int32 issue rate, 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s
from NVIDIA's Hopper whitepaper, a quarter of the 67 T/s float32 rate that
counts an FMA as two operations), and as its last line
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
I8_N = 16384  # the idct8x8 batch of tests/test_pallas_itx8.py's A/B note
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
OPS_PS = 132 * 64 * 1.98e9  # H100 SXM int32 operations/s (16.7 T/s)
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


def bound(nbytes, ops):
    """(least ms the card could take, what binds it)."""
    b = nbytes / HBM_BPS * 1e3
    o = ops / OPS_PS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def itx_ops(w, h, first, second):
    """32-bit operations of the itx kernel on one batch (csrc/itx.cu
    itx_block): the row transforms of each block's first code, the column
    transforms of its second, and per coefficient the 181/256 scale of 2:1
    rectangles, the round, shift and clip between the passes and the
    output round and shift."""
    import numpy as np

    from rav1d_tpu_torch.ops.cuda.gen_itx_1d import op_count

    names = ("dct", "adst", "flipadst", "identity")

    def per_code(codes, n):
        cnt = np.bincount(codes, minlength=4)
        return sum(int(c) * op_count(names[i], n) for i, c in enumerate(cnt))

    rect2 = w * 2 == h or h * 2 == w
    per_coef = (3 if rect2 else 0) + 4 + 2
    return (h * per_code(first, w) + w * per_code(second, h)
            + len(first) * w * h * per_coef)


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
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth

    t0 = time.perf_counter()
    md5 = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), [data])
    return md5, (time.perf_counter() - t0) * 1e3


def slice_phase(dev):
    """The main path: synthetic 1080p pictures through the port."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import run
    from rav1d_tpu_torch.ops.cuda import itx as I

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    if (digests["width"], digests["height"]) != (W, H):
        raise AssertionError("smoke_digests.json is for another picture size")
    streams = [synth.still_picture(W, H, s) for s in SEEDS]
    oracle = []
    feats = []
    for s, data in zip(SEEDS, streams):
        md5, ms = host_decode(data)
        want = digests["md5"][str(s)]
        log(f"host path seed {s} {W}x{H}: {ms:.1f} ms  md5 {md5[0]}  "
            f"{'==' if md5 == [want] else '!='} committed digest")
        if md5 != [want]:
            raise AssertionError(f"host path seed {s} differs from the "
                                 "committed digest")
        oracle.append(md5)
        (fp,) = synth.capture_frames([data])
        feats.append(synth.features(*fp))
        log("  features " + json.dumps(feats[-1]))

    # warm-up (CUDA context, lazy module loads) on a small picture
    synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False), device=dev),
                      [synth.still_picture(256, 128, 7)])
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
            T.Decoder(T.Settings(apply_grain=False), device=dev), [data]))
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
    (kernel ms, plain ms, max |err|, bytes, operations)."""
    import torch

    from rav1d_tpu_torch.engine.kernels import itx_any_core
    from rav1d_tpu_torch.ops.cuda import itx as I

    lanes = {}
    for ft in feats:
        for k, n in ft["tx_lanes"].items():
            lanes[k] = max(lanes.get(k, 0), n)
    tk = tp = 0.0
    worst = nbytes = ops = 0
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
        nbytes += n * (2 * w * h + 2) * 4
        ops += itx_ops(w, h, args[1].cpu().numpy(), args[2].cpu().numpy())
        log(f"itx {key:>5} N={n:6d}: kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms")
    log(f"itx per frame (all classes): kernel {tk:.4f} ms  plain {tp:.4f} ms"
        f" (outputs bit-identical at these N); {nbytes} bytes, {ops} ops")
    return tk, tp, worst, nbytes, ops


def idct8x8_phase(dev):
    """The 8x8 DCT_DCT batch: its entry point once at N=I8_N (launches
    counted), then kernel vs plain at N=256 x bpc 8/10/12 and at N=I8_N,
    timed there; the kernel also at 16 x I8_N, past the L2 cache. Returns
    (launches, max |err|, kernel ms, plain ms, bytes, operations) at
    N=I8_N."""
    import torch

    from rav1d_tpu_torch.ops import itx8
    from rav1d_tpu_torch.ops.cuda.gen_itx_1d import op_count

    big = kernel_inputs(8, 8, 8, I8_N, 88, dev)[0]
    itx8.launches = 0
    out = itx8.idct8x8_batch(big)
    torch.cuda.synchronize()
    launches = itx8.launches
    if launches <= 0 or out.shape != big.shape:
        raise AssertionError("the idct8x8 kernel was not launched")

    worst = 0
    cases = [(bpc, kernel_inputs(8, 8, bpc, 256, 800 + bpc, dev)[0])
             for bpc in (8, 10, 12)] + [(8, big)]
    for bpc, cb in cases:
        got = itx8.idct8x8_batch(cb, bpc)
        ref = itx8.idct8x8_batch_plain(cb, bpc)
        torch.cuda.synchronize()
        worst = max(worst, int((got.to(torch.int64) - ref.to(torch.int64))
                               .abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"idct8x8 kernel != plain at N={cb.shape[0]}"
                                 f" bpc {bpc}")
    k_ms = cuda_ms(lambda: itx8.idct8x8_batch(big), 50)
    p_ms = cuda_ms(lambda: itx8.idct8x8_batch_plain(big), 5)
    nbytes = I8_N * 64 * 4 * 2
    ops = I8_N * (16 * op_count("dct", 8) + 64 * (4 + 2))
    log(f"idct8x8: bit-identical to its plain version at N=256 x bpc "
        f"8/10/12 and N={I8_N}; N={I8_N}: kernel {k_ms:.4f} ms  plain "
        f"{p_ms:.4f} ms; {nbytes} bytes, {ops} ops")
    huge = big.repeat(16, 1, 1)
    h_ms = cuda_ms(lambda: itx8.idct8x8_batch(huge), 20)
    log(f"idct8x8 N={huge.shape[0]} ({16 * nbytes} bytes): kernel "
        f"{h_ms:.4f} ms, bound {bound(16 * nbytes, 16 * ops)[0]:.4f} ms")
    return launches, worst, k_ms, p_ms, nbytes, ops


def vector_phase(dev):
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

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
        dec = T.Decoder(T.Settings(apply_grain=False), device=dev)
        m = hashlib.md5()
        for pkt in IvfDemuxer(path):
            dec.send_data(pkt.data, pkt.timestamp)
            while True:
                try:
                    pic = dec.get_picture()
                except T.EAgain:
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
    from rav1d_tpu_torch.native import BUILD
    from rav1d_tpu_torch.native import syntax as native_syntax
    from rav1d_tpu_torch.ops.cuda import itx as I

    dev = torch.device("cuda")
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if not native_syntax.enabled():
        raise AssertionError("the port's native syntax library did not load")
    so = native_syntax.LIB._name
    if os.path.dirname(so) != BUILD:
        raise AssertionError(f"native syntax library {so} is not the port's")
    log(f"syntax backend: native C ({os.path.relpath(so, HERE)})")

    t0 = time.perf_counter()
    I.lib()
    log(f"set-up: itx and idct8x8 kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    worst = kernel_phase(dev)
    launches, feats = slice_phase(dev)
    k_ms, p_ms, worst_main, itx_bytes, itx_ops_n = timing_phase(dev, feats)
    worst = max(worst, worst_main)
    i8 = idct8x8_phase(dev)
    vector_phase(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = sorted(m for m in sys.modules
                 if m == "rav1d_tpu" or m.startswith("rav1d_tpu."))
    if ref:
        raise AssertionError(f"modules of rav1d_tpu were imported: {ref}")

    kernels = []
    for name, replaces, n_launch, err, ms, pms, nbytes, ops in (
        ("itx", "rav1d_tpu/ops/pallas/itx_all.py:110", launches, worst,
         k_ms, p_ms, itx_bytes, itx_ops_n),
        ("idct8x8", "rav1d_tpu/ops/pallas/itx8.py:97", *i8),
    ):
        b_ms, b_by = bound(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/itx.cu", "replaces": replaces,
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes AV1's integer inverse
            # transform bit-exactly
            "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
