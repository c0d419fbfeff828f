"""Drive rav1d_tpu_torch's intra and inter paths, at every bit depth and
chroma layout and with superres, once on a CUDA card, end to end.

    python3 chip_smoke.py [--test-data DIR]

Phases (any failure exits non-zero before the last line):
1. set-up: build the hand-written kernels (csrc/itx.cu: the itx frame
   kernel and the 8x8 DCT_DCT kernel; nvcc, sm_90a) and print ptxas's
   registers, stack frames and spills. The port's native syntax library
   (csrc/host/, built into rav1d_tpu_torch/build/ when the port is
   imported) must have loaded: a decode on the Python syntax anchor would
   change every host number;
2. kernel: the itx kernel, through its per-size entry points (ops/cuda/
   itx.py itx and wht), against the plain torch versions on the card, all
   19 tx sizes and the WHT x bpc 8/10/12, N=1000 random int32 blocks
   including extreme values; bit-identical required;
Each stream below runs through stream_on_card: the port's host path
(Decoder(host_path=True), captured) must give the committed digests
(rav1d_tpu_torch/smoke_digests.json) where there are some; on each
engine frame's blob, packed from that capture, the residual program (one
itx launch) must equal resid_plain; then one rav1d_tpu_torch.Decoder(
device="cuda") decodes the stream frame by frame to the host path's MD5s
with no fallback but the planner's own, no upload of a host reference
plane (every reference is the engine's own device output), exactly one
itx launch per engine frame and no call of the plain transforms
(engine/kernels.py itx_any_core, wht_core), printing per-frame stage_ms.
3. slice: seeded 1920x1080 synthetic AV1 still pictures
   (rav1d_tpu_torch/synth.py), after a small picture's decode;
4. inter: a seeded 1920x1080 synthetic inter sequence (synth.
   inter_sequence: a key frame and two inter frames with every inter tool
   of 4:2:0); every inter slot but segy00/segy10 (4:2:2 and 4:4:4 only)
   must carry tiles, and interintra wave items must be present; then the
   inter program alone on each inter frame's blob (CUDA events and
   torch.profiler);
5. high bit depth: the committed 1080p streams of smoke_digests.json
   "formats": a 10-bit 4:2:0 key + two inter frames and a 12-bit 4:4:4
   picture, whose blobs hold word coefficients (the itx kernel's 10/12-bit
   branch);
6. formats: at 640x360, still pictures at 8, 10 and 12 bits in 4:0:0,
   4:2:2 and 4:4:4, 10-bit inter sequences in 4:2:2 (segy10 must carry
   tiles), 4:4:4 (segy00) and 4:0:0, and an 8-bit superres inter sequence,
   whose fourth frame the planner sends to the host path (scaled
   references);
7. headers: at 640x360, an 8-bit and a 10-bit sequence with the header
   tools of synth.Tools on (2x2 tiles, segmentation with a lossless
   segment, so the frame blobs carry WHT blocks, delta q and delta lf,
   loop filter deltas, TX_MODE_LARGEST with the reduced transform set;
   128-px superblocks in the 8-bit one, 64-px LR units in the 10-bit
   one), no frame falling back;
8. residual: the multi-device residual (parallel/resid.py) on an NCCL
   process group of one rank (file:// init) over the first still
   picture's captured coefficient store: sharded_residual_plane, one itx
   launch per non-WHT size group and no plain transform call, must equal
   single_device_residual_plane (the plain transforms on the card); both
   timed with CUDA events beside the frame's resid program;
9. CLI: rav1d_tpu_torch.cli.main(["-i", <a 640x360 IVF file of an 8-bit
   inter sequence>, "--verify", <its host-path MD5>, "--frametimes",
   <file>]) in process must return 0, with one itx launch per frame; the
   per-frame times are printed;
10. timing: on the blobs of phases 3 and 5, the frame launch and
   resid_plain (CUDA events), and torch.profiler windows over resid calls
   and over each class of the frame launched alone, which give the
   kernel's device time apart from its launch;
11. idct8x8: the 8x8 DCT_DCT batch (ops/itx8.py; on no decoder path): its
   entry point driven once at N=16384 with the launch count reset before
   and read after, then the kernel against idct8x8_batch_plain,
   bit-identical at N=256 for bpc 8/10/12 (1/8 of the blocks full-range
   int32) and at N=16384, where both are timed;
12. vectors: with `--test-data DIR` naming a dav1d-test-data directory,
   two conformance streams against their meson MD5s, and the first frames
   of the bench's inter stream (16) and of its 10-bit stream
   318_tx_4x4.ivf (8, bench.py's frame limit) against the port's host
   path, with no fallback.
Then neither JAX nor any module of rav1d_tpu may have been imported.

Prints the card's name and power limit, the syntax backend, per-frame
stage times (CUDA events), the host path's time on the same frames, the
inter slots' tile counts per frame, the script's own seconds, a
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
# (vector, frames) held to the port's host path: the bench's inter stream,
# and its 1080p_10bit stream at bench.py's frame limit
HOST_PATH_VECTORS = [("8-bit/data/00000627.ivf", 16),
                     ("10-bit/issues/318_tx_4x4.ivf", 8)]
# inter slots that only 4:2:2 and 4:4:4 reach
NOT_420 = ("segy00", "segy10")


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


def variant(code, n):
    """The 1-D transform an n-point pass runs for `code` (a code the size
    does not allow runs the dct)."""
    if n <= 16:
        return ("dct", "adst", "flipadst", "identity")[code] if 0 <= code < 4 \
            else "dct"
    return "identity" if n == 32 and code == 3 else "dct"


def itx_frame_work(words, hdr, tx_valid, bpc):
    """(bytes, operations) of the itx frame launch on one blob: each stored
    coefficient read once (2 B at 8 bpc), each block's descriptors (4 B a
    row) and each residual written once (4 B); the row transforms of each
    block's first code over its min(h,32) rows, the column transforms of
    its second code, and per value the 181/256 scale of 2:1 rectangles, the
    round, shift and clip between the passes and the output round and
    shift (the WHT: its input shift and 4-point transforms)."""
    import numpy as np

    from rav1d_tpu_torch.ops.cuda.gen_itx_1d import op_count
    from rav1d_tpu_torch.ops.cuda.itx import frame_table

    cnt = {}

    def ops(name, n):
        if (name, n) not in cnt:
            cnt[name, n] = op_count(name, n)
        return cnt[name, n]

    nbytes = nops = 0
    for wh, n, base, B in frame_table(hdr, tx_valid, words.size):
        w, h = (4, 4) if wh == 0 else divmod(int(wh), 100)
        rows = 2 if wh == 0 else 4
        nc = (int(n) + B - 1) // B
        d = words[base : base + nc * rows * B].reshape(nc, rows, B)
        d = d.transpose(1, 0, 2).reshape(rows, -1)[:, :n]
        sh, sw = min(h, 32), min(w, 32)
        nbytes += int(n) * (sh * sw * (2 if bpc == 8 else 4) + 4 * rows
                            + 4 * w * h)
        if wh == 0:
            nops += int(n) * (16 + 8 * ops("wht", 4))
            continue
        for code, k in zip(*np.unique(d[2], return_counts=True)):
            nops += int(k) * sh * ops(variant(int(code), w), w)
        for code, k in zip(*np.unique(d[3], return_counts=True)):
            nops += int(k) * w * ops(variant(int(code), h), h)
        rect2 = w * 2 == h or h * 2 == w
        nops += int(n) * ((3 * sh * sw if rect2 else 0) + 4 * sh * w
                          + 2 * h * w)
    return nbytes, nops


def kernel_inputs(w, h, bpc, n, seed, dev):
    """(cb (n, min(h,32), min(w,32)), first codes, second codes) int32 on
    `dev`: coefficients in the bpc's range, 1/8 of the blocks full-range
    int32, codes 0-3 and a few that the size does not allow."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shape = (n, min(h, 32), min(w, 32))
    cmax = (1 << (bpc + 7)) - 1
    cb = rng.integers(-cmax, cmax, size=shape, dtype=np.int64)
    cb[: n // 8] = rng.integers(-(2**31), 2**31 - 1, size=(n // 8,) + shape[1:])
    cb = cb.astype(np.int32)
    f = rng.integers(0, 4, size=n).astype(np.int32)
    s = rng.integers(0, 4, size=n).astype(np.int32)
    f[-3:] = s[-3:] = 5
    return [torch.from_numpy(a).to(dev) for a in (cb, f, s)]


def max_err(got, ref):
    import torch

    return int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())


def kernel_phase(dev):
    """Kernel vs plain version, every size and the WHT x bitdepth. Returns
    max |err|."""
    import torch

    from rav1d_tpu_torch.engine.kernels import itx_any_core, wht_core
    from rav1d_tpu_torch.engine.layout import SIZES
    from rav1d_tpu_torch.ops.cuda import itx as I

    worst = 0
    for w, h in SIZES + [(0, 0)]:
        for bpc in (8, 10, 12):
            if w:
                args = kernel_inputs(w, h, bpc, 1000, w * 100 + h * 7 + bpc, dev)
                got = I.itx(*args, w, h, bpc)
                ref = itx_any_core(*args, w, h, bpc)
            else:
                cb = kernel_inputs(4, 4, bpc, 1000, 4400 + bpc, dev)[0]
                got, ref = I.wht(cb), wht_core(cb)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            if not torch.equal(got, ref):
                raise AssertionError(f"itx kernel != plain at {w}x{h} "
                                     f"(0x0: the WHT) bpc {bpc}")
    log(f"kernel phase: itx kernel bit-identical to its plain versions on "
        f"{len(SIZES)} sizes and the WHT x bpc 8/10/12 (N=1000)")
    return worst


def slice_phase(dev):
    """The main path: synthetic 1080p still pictures through
    stream_on_card, held to their committed digests, after the decode of
    a small picture (CUDA context, lazy module loads). Returns (itx
    launches, max |err| of ra, the frames' blobs, the first picture's
    captured [(f, plan)])."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    if (digests["width"], digests["height"]) != (W, H):
        raise AssertionError("smoke_digests.json is for another picture size")
    synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False), device=dev),
                      [synth.still_picture(256, 128, 7)])
    torch.cuda.synchronize()
    launches = worst = 0
    blobs, captured = [], []
    for s in SEEDS:
        n, err, frames = stream_on_card(dev, f"still seed {s} {W}x{H}",
                                        [synth.still_picture(W, H, s)],
                                        want=[digests["md5"][str(s)]],
                                        blobs=blobs)
        launches += n
        worst = max(worst, err)
        captured.append(frames)
    return launches, worst, blobs, captured[0]


def inter_phase(dev):
    """The inter path: synth.inter_sequence at 1080p through
    stream_on_card, held to its committed digests, with every inter slot
    but segy00/segy10 (4:2:2 and 4:4:4 only) carrying tiles and interintra
    wave items present; then the inter program alone on each inter frame's
    blob (inter_timing). Returns (itx launches, max |err| of ra)."""
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine.layout import SLOTS

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        want = json.load(fh)["inter"]
    launches, worst, frames = stream_on_card(
        dev, f"inter seed {want['seed']} {W}x{H}",
        synth.inter_sequence(W, H, want["seed"]), want=want["md5"],
        slots=[k for k in SLOTS if k not in NOT_420], interintra=True)
    inter_timing(dev, frames)
    return launches, worst


def inter_timing(dev, frames):
    """The inter program alone on each inter frame's blob: per call, CUDA
    events (host dispatch included) and the device time of all its
    kernels (torch.profiler), whose ratio is the device's busy share of
    the stage."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.engine.run import stack_planes

    for i, (f, plan) in enumerate(frames):
        pk = pack_frame(f, plan)
        if pk.srcs is None:
            continue
        ah, aw = plan.ah, plan.aw
        d, _ = Uploader(dev).upload(pk, ah * aw, 8)
        ra = P.resid(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=8)[0]
        sY = stack_planes(pk.srcs[0], dev, (ah, aw))
        sC = stack_planes(pk.srcs[1], dev, f.cur.u.shape)
        zeros = torch.zeros((3, ah, aw), dtype=torch.int32, device=dev)

        def call():
            P.inter(zeros, ra, d, pk.hdr, pk.inter_runs, sY, sC, ah=ah,
                    aw=aw, bpc=8, vwY=f.cur.w, vhY=f.cur.h,
                    vwC=(f.cur.w + 1) >> 1, vhC=(f.cur.h + 1) >> 1)

        ms = cuda_ms(call, 10)
        dms = profiled_device_ms(call, 5)
        log(f"inter program frame {i}: {ms:.3f} ms per call (CUDA events), "
            f"device {'not measured' if dms is None else f'{dms:.3f} ms'} "
            f"(torch.profiler, all kernels)"
            + ("" if dms is None else f", busy {100 * dms / ms:.1f}%"))


def profiled_device_ms(fn, reps):
    """Device time per call of every kernel fn launches, in a
    torch.profiler window over `reps` calls; None if it shows none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            t = getattr(e, "device_time_total", None)
            us += e.cuda_time_total if t is None else t
    return us / reps / 1e3 if us else None


def profiled_kernel_ms(fn, name, reps):
    """Device time per launch of the kernel whose name contains `name`, in a
    torch.profiler window over `reps` calls of fn; None if the profiler
    shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a window now and then records no device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if name in e.key and e.count:
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = e.cuda_time_total
                if us:
                    return us / e.count / 1e3
    return None


def timing_phase(blobs):
    """On each frame's blob (stream_on_card's blobs): the itx frame launch
    (CUDA events, host launch included; and its device time from
    torch.profiler), the whole resid program, resid_plain, and each class
    of the frame launched alone. Returns per blob (bpc, launch ms, device
    ms or None, plain ms, bytes, operations)."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.layout import SIZES
    from rav1d_tpu_torch.ops.cuda import itx as I

    rows = []
    for label, bpc, d, hdr, tv, ah, aw in blobs:
        ra = torch.zeros(6 * ah * aw, dtype=torch.int32, device=d.device)
        k_ms = cuda_ms(lambda: I.itx_frame(d, hdr, tv, ra, aw, bpc), 50)
        dev_ms = profiled_kernel_ms(
            lambda: P.resid(d, hdr, tv, ah=ah, aw=aw, bpc=bpc),
            "itx_frame_kernel", 10)
        r_ms = cuda_ms(lambda: P.resid(d, hdr, tv, ah=ah, aw=aw, bpc=bpc), 20)
        p_ms = cuda_ms(
            lambda: P.resid_plain(d, hdr, tv, ah=ah, aw=aw, bpc=bpc), 3)
        nbytes, ops = itx_frame_work(d.cpu().numpy(), hdr, tv, bpc)
        b_ms, b_by = bound(nbytes, ops)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.5f} ms"
        log(f"itx frame {label} ({bpc} bpc): {sum(tv.values())} blocks in "
            f"{len(tv)} classes; launch {k_ms:.5f} ms (CUDA events), kernel "
            f"device time {dev_txt} (torch.profiler), resid {r_ms:.5f} ms, "
            f"resid_plain {p_ms:.4f} ms; {nbytes} bytes, {ops} ops, bound "
            f"{b_ms:.5f} ms ({b_by})")
        rows.append((bpc, k_ms, dev_ms, p_ms, nbytes, ops))
        # each class of the frame alone: a launch over its part of the table
        per = []
        for key in [k for k in list(range(len(SIZES))) + ["wht"] if k in tv]:
            n = tv[key]
            name = "wht" if key == "wht" else "%dx%d" % SIZES[key]
            ms = profiled_kernel_ms(
                lambda: I.itx_frame(d, hdr, {key: n}, ra, aw, bpc),
                "itx_frame_kernel", 5)
            per.append(f"{name} {n}: "
                       + ("not measured" if ms is None else f"{ms:.5f}"))
        log(f"  {label} device ms per class alone (blocks: ms): "
            + "; ".join(per))
    return rows


def stream_on_card(dev, label, packets, *, want=None, fallbacks=(),
                   slots=(), interintra=False, blobs=None):
    """One stream through the port on the card. The host path (captured:
    each frame's plan, and the MD5s; its time includes the capture) must
    give the committed digests `want` where they are given, and its
    planner must send exactly the frames `fallbacks` to the host; the
    inter slots `slots` must carry tiles, and interintra wave items must
    be present if `interintra`. On
    each engine frame's blob the resid program (one itx launch) must equal
    resid_plain (the blobs are appended to the list `blobs` if one is
    given). Then one Decoder(device="cuda") must decode the stream frame by
    frame to the host path's MD5s, with those fallbacks only, no upload of
    a host reference plane, one itx launch per engine frame and no call of
    the plain transforms. Returns (itx launches, max |err| of ra, the
    captured [(f, plan)])."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import kernels, run
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import itx as I

    t0 = time.perf_counter()
    host = []
    frames = synth.capture_frames(packets, host)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"{label}: host path (with capture) {len(host)} frames "
        f"{host_ms:.1f} ms  md5 {host}"
        + ("" if want is None else
           f"  {'==' if host == want else '!='} committed digests"))
    if want is not None and host != want:
        raise AssertionError(f"{label}: host path differs from the "
                             "committed digests")
    planned = tuple(i for i, (_, plan) in enumerate(frames) if plan is None)
    if planned != tuple(fallbacks):
        raise AssertionError(f"{label}: the planner sends frames {planned} "
                             f"to the host path, not {tuple(fallbacks)}")
    tiles = {}
    ii = 0
    for i, (f, plan) in enumerate(frames):
        if plan is None:
            continue
        ft = synth.features(f, plan)
        line = {k: ft[k] for k in ("items", "waves")}
        if "inter_tiles" in ft:
            for k, v in ft["inter_tiles"].items():
                tiles[k] = tiles.get(k, 0) + v
            ii += ft["ii_items"]
            line.update((k, ft[k]) for k in ("inter_tiles", "ii_items",
                                             "pool_rows", "lap_rows",
                                             "pool_cap"))
        log(f"  frame {i} features " + json.dumps(line))
    empty = [k for k in slots if not tiles.get(k)]
    if empty or (interintra and not ii):
        raise AssertionError(f"{label}: inter slots without tiles {empty}, "
                             f"interintra items {ii}")

    # the residual program on each engine frame's blob against its plain
    # version (and the allocator brought to the frame's buffer sizes)
    worst = 0
    for i, (f, plan) in enumerate(frames):
        pk = None if plan is None else pack_frame(f, plan)
        if pk is None:
            continue
        ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
        d, _ = Uploader(dev).upload(pk, ah * aw, bpc)
        ra = P.resid(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=bpc)[0]
        ref = P.resid_plain(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=bpc)[0]
        torch.cuda.synchronize()
        worst = max(worst, max_err(ra, ref))
        if not torch.equal(ra, ref):
            raise AssertionError(f"{label} frame {i}: resid (itx kernel, "
                                 f"{bpc} bpc) != resid_plain")
        if blobs is not None:
            blobs.append((f"{label} frame {i}", bpc, d, pk.hdr, pk.tx_valid,
                          ah, aw))

    T.engine.stats.update(frames=0, fallback=0, ref_uploads=0)
    I.launches = 0
    kernels.calls = 0
    dec = T.Decoder(T.Settings(apply_grain=False), device=dev)
    got, fell = [], []
    for i, data in enumerate(packets):  # frame by frame: stage_ms per frame
        run.reset_stats()
        fb = T.engine.stats["fallback"]
        t0 = time.perf_counter()
        got += synth.decode_md5s(dec, [data])
        ms = (time.perf_counter() - t0) * 1e3
        if T.engine.stats["fallback"] > fb:
            fell.append(i)
        log(f"  port frame {i}: {ms:.1f} ms wall  md5 {got[-1]}  "
            f"{'==' if got[-1:] == host[i : i + 1] else '!='} host"
            + ("  (host path: the planner's gate)" if i in fell else ""))
        log("    stage_ms " + json.dumps({k: round(v, 3)
                                          for k, v in run.stage_ms.items()}))
    launches = I.launches
    plain_calls = kernels.calls
    stats = dict(T.engine.stats)
    log(f"  {label}: engine stats {stats}  itx launches {launches}  plain "
        f"transform calls {plain_calls}")
    if got != host:
        raise AssertionError(f"{label}: port output differs from the host "
                             "path")
    if tuple(fell) != tuple(fallbacks) or stats["frames"] != len(packets):
        raise AssertionError(f"{label}: frames {fell} fell back, not "
                             f"{tuple(fallbacks)}: {stats}")
    if stats["ref_uploads"]:
        raise AssertionError(f"{label}: a reference plane was uploaded from "
                             "the host")
    if launches != len(packets) - len(fallbacks):
        raise AssertionError(f"{label}: {launches} itx launches for "
                             f"{len(packets) - len(fallbacks)} engine frames")
    if plain_calls:
        raise AssertionError(f"{label}: {plain_calls} plain transform calls "
                             "on the card")
    return launches, worst, frames


def high_bitdepth_phase(dev):
    """The committed 1080p streams of smoke_digests.json "formats" (a
    10-bit 4:2:0 key + two inter frames, the format of the bench's
    1080p_10bit configuration, and a 12-bit 4:4:4 picture) through
    stream_on_card. Returns (itx launches, max |err|, the frames' blobs)."""
    from rav1d_tpu_torch import synth

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    launches = worst = 0
    blobs = []
    for name in sorted(digests["formats"]):
        n, err, _ = stream_on_card(dev, f"{name} {W}x{H}",
                                   synth.smoke_stream(digests, name),
                                   want=digests["formats"][name]["md5"],
                                   blobs=blobs)
        launches += n
        worst = max(worst, err)
    return launches, worst, blobs


FMT_W, FMT_H = 640, 360


def formats_phase(dev):
    """Every other format at 640x360 through stream_on_card: still
    pictures at 8, 10 and 12 bits in 4:0:0, 4:2:2 and 4:4:4; 10-bit
    inter sequences in 4:2:2 (segy10 must carry tiles), 4:4:4 (segy00)
    and 4:0:0; and an 8-bit superres inter sequence, whose fourth frame
    the planner sends to the host path (scaled references). Returns the
    itx launches and the max |err| of ra."""
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.headers import PixelLayout as PL

    streams = []
    for bpc in (8, 10, 12):
        for layout in (PL.I400, PL.I422, PL.I444):
            streams.append((f"still {bpc}-bit {layout.name}", [
                synth.still_picture(FMT_W, FMT_H, bpc + int(layout), bpc=bpc,
                                    layout=layout)], (), ()))
    for layout, slots in ((PL.I422, ("segy10",)), (PL.I444, ("segy00",)),
                          (PL.I400, ())):
        streams.append((f"inter 10-bit {layout.name}", synth.inter_sequence(
            FMT_W, FMT_H, 2, bpc=10, layout=layout), (), slots))
    streams.append(("inter 8-bit I420 superres", synth.inter_sequence(
        FMT_W, FMT_H, 2, superres=True), (3,), ()))
    launches = worst = 0
    for label, packets, fallbacks, slots in streams:
        n, err, _ = stream_on_card(dev, f"{label} {FMT_W}x{FMT_H}", packets,
                                   fallbacks=fallbacks, slots=slots)
        launches += n
        worst = max(worst, err)
    return launches, worst


def headers_phase(dev):
    """The header tools of synth.Tools at 640x360 through stream_on_card:
    an 8-bit sequence with 128-px superblocks and a 10-bit sequence with
    64-px LR units, both with 2x2 tiles, segmentation (a lossless segment:
    WHT blocks must reach the frame blobs), delta q and delta lf, loop
    filter deltas and TX_MODE_LARGEST with the reduced transform set; no
    frame may fall back. Returns the itx launches and the max |err| of
    ra."""
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.synth import Tools

    common = dict(tiles=(1, 1), segmentation=True, delta_q=True,
                  lf_deltas=True, tx_mode_largest=True)
    streams = [
        ("headers 8-bit sb128", synth.inter_sequence(
            FMT_W, FMT_H, 6, tools=Tools(sb128=True, delta_lf_multi=True,
                                         **common))),
        ("headers 10-bit lr64", synth.inter_sequence(
            FMT_W, FMT_H, 7, bpc=10,
            tools=Tools(lr_unit_shift=0, **common))),
    ]
    launches = worst = 0
    for label, packets in streams:
        n, err, frames = stream_on_card(dev, f"{label} {FMT_W}x{FMT_H}",
                                        packets)
        launches += n
        worst = max(worst, err)
        wht = sum(pack_frame(f, plan).tx_valid.get("wht", 0)
                  for f, plan in frames)
        tiling = {(f.frame_hdr.tiling.cols, f.frame_hdr.tiling.rows)
                  for f, _ in frames}
        log(f"  {label}: {wht} WHT blocks, tiles {sorted(tiling)}")
        if not wht or tiling != {(2, 2)}:
            raise AssertionError(f"{label}: no WHT block or not 2x2 tiles")
    return launches, worst


def residual_phase(dev, frames, tmp):
    """The multi-device residual on an NCCL process group of one rank
    over the captured coefficient store of `frames` (one picture's
    [(f, plan)]): sharded_residual_plane must make one itx launch per
    non-WHT size group and no plain transform call, and equal
    single_device_residual_plane (plain transforms, on the card). Times
    (CUDA events): the sharded call, the single-device oracle, and the
    frame's resid program on its blob (what stage_ms.resid measures).
    Returns (itx launches, max |err|)."""
    import torch
    import torch.distributed as dist

    from rav1d_tpu_torch.engine import kernels
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.parallel import resid as R

    (f, plan), = frames
    store = f.coef_store
    ah, aw = f.cur.y.shape
    psz, bpc = ah * aw, f.cur.bpc
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "nccl_init"), world_size=1, rank=0)
    try:
        groups = R.group_residuals(store, psz, aw, 1)
        cf = torch.from_numpy(store.cf[: store.cf_pos].copy()).to(dev)
        torch.cuda.synchronize()
        I.launches = 0
        kernels.calls = 0
        got = R.sharded_residual_plane(cf, groups, psz, aw, bpc)
        torch.cuda.synchronize()
        launches, calls = I.launches, kernels.calls
        want = R.single_device_residual_plane(cf, groups, psz, aw, bpc)
        torch.cuda.synchronize()
        err = max_err(got, want)
        lanes = sum(int((g[3] < 3 * psz).sum()) for g in groups)
        log(f"residual: NCCL world 1, {lanes} blocks in {len(groups)} size "
            f"groups (WHT left out); itx launches {launches}, plain "
            f"transform calls {calls}, max |err| {err}")
        if calls or launches != len(groups) or not torch.equal(got, want):
            raise AssertionError("sharded_residual_plane: not one launch per "
                                 "size group, or != the single-device plane")
        if not want.abs().sum():
            raise AssertionError("residual: the plane is empty")
        s_ms = cuda_ms(lambda: R.sharded_residual_plane(cf, groups, psz, aw,
                                                        bpc), 10)
        p_ms = cuda_ms(lambda: R.single_device_residual_plane(
            cf, groups, psz, aw, bpc), 3)
    finally:
        dist.destroy_process_group()
    pk = pack_frame(f, plan)
    d, _ = Uploader(dev).upload(pk, psz, bpc)
    r_ms = cuda_ms(lambda: P.resid(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw,
                                   bpc=bpc), 20)
    log(f"residual {f.cur.w}x{f.cur.h}: sharded_residual_plane "
        f"{s_ms:.4f} ms per call (CUDA events: gather, {len(groups)} "
        f"launches, scatter, "
        f"all_reduce), single_device_residual_plane (plain) {p_ms:.4f} ms, "
        f"the frame's resid program (one launch, WHT too) {r_ms:.4f} ms")
    return launches, err


def cli_phase(dev, tmp):
    """rav1d_tpu_torch.cli.main on a 640x360 IVF file of an 8-bit inter
    sequence, with --verify at its host-path MD5 and --frametimes: it must
    return 0 after one itx launch per frame. Returns the itx launches."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import cli, synth
    from rav1d_tpu_torch.ops.cuda import itx as I

    packets = synth.inter_sequence(FMT_W, FMT_H, 8)
    path = os.path.join(tmp, "cli.ivf")
    synth.write_ivf(path, packets, FMT_W, FMT_H)
    md5 = synth.stream_md5(packets)
    times = os.path.join(tmp, "frametimes.txt")
    fb = T.engine.stats["fallback"]
    I.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["-i", path, "--verify", md5, "--frametimes", times])
    wall = time.perf_counter() - t0
    launches = I.launches
    with open(times) as fh:
        ms = [int(v) / 1e6 for v in fh.read().split()]
    log(f"cli {FMT_W}x{FMT_H}: --verify {md5} rc {rc}, {wall:.2f} s, "
        f"frametimes ms {[round(v, 3) for v in ms]}, itx launches "
        f"{launches}, fallback {T.engine.stats['fallback'] - fb}")
    if rc != 0 or launches != len(packets) or len(ms) != len(packets):
        raise AssertionError("cli: --verify failed, or not one itx launch "
                             "and one frame time per frame")
    return launches


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


def vector_phase(dev, d):
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    if not d or not os.path.isdir(d):
        log("vector phase: dav1d-test-data not found (--test-data not "
            "given or not a directory); skipped")
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
    for rel, n in HOST_PATH_VECTORS:
        first_frames_phase(dev, d, rel, n)


def first_frames_phase(dev, d, rel, n):
    """The first n frames of a vector, frame by frame against the port's
    host path, with no fallback."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    path = os.path.join(d, rel)
    if not os.path.exists(path):
        log(f"vector phase: {rel} not found; skipped")
        return
    host = T.Decoder(T.Settings(apply_grain=False), host_path=True)
    packets, want = [], []
    for pkt in IvfDemuxer(path):
        if len(want) >= n:
            break
        packets.append(pkt.data)
        want += synth.decode_md5s(host, [pkt.data])
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device=dev), packets)
    fb = T.engine.stats["fallback"] - before["fallback"]
    log(f"vector {rel}: {len(got)} frames, "
        f"{sum(a == b for a, b in zip(got, want))} equal to the host path, "
        f"fallback {fb}")
    if got != want or fb:
        raise AssertionError(f"{rel}: differs from the host path or fell "
                             f"back ({fb})")


def main():
    import argparse
    import tempfile

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--test-data", help="a dav1d-test-data directory for "
                    "the vector phase (skipped without it)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    import rav1d_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rav1d_tpu_torch.native import BUILD
    from rav1d_tpu_torch.native import syntax as native_syntax
    from rav1d_tpu_torch.ops.cuda import build
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
    for ln in build.LOGS.get("itx", "").splitlines():  # ptxas -v
        if any(k in ln for k in ("entry function", "Function properties",
                                 "Used", "stack frame")):
            log("  " + ln.replace("ptxas info    :", "").strip())

    worst = kernel_phase(dev)
    launches, worst_ra, blobs, still = slice_phase(dev)
    worst = max(worst, worst_ra)
    for phase in (inter_phase, high_bitdepth_phase, formats_phase,
                  headers_phase):
        n, err, *got = phase(dev)
        launches += n
        worst = max(worst, err)
        blobs += got[0] if got else []
    with tempfile.TemporaryDirectory() as tmp:
        n, err = residual_phase(dev, still, tmp)
        launches += n + cli_phase(dev, tmp)
        worst = max(worst, err)
    rows = timing_phase(blobs)
    i8 = idct8x8_phase(dev)
    vector_phase(dev, args.test_data)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = sorted(m for m in sys.modules
                 if m == "rav1d_tpu" or m.startswith("rav1d_tpu."))
    if ref:
        raise AssertionError(f"modules of rav1d_tpu were imported: {ref}")

    means = {}  # bpc: per-frame means (launch, device, plain, bytes, ops)
    for bpc in (8, 10, 12):
        got = [r[1:] for r in rows if r[0] == bpc]
        n = len(got)
        devs = [r[1] for r in got]
        means[bpc] = [sum(r[i] for r in got) / n for i in (0, 2, 3, 4)]
        b_ms, b_by = bound(*means[bpc][2:])
        log(f"itx per frame at {bpc} bpc (mean of {n}): launch "
            f"{means[bpc][0]:.5f} ms, device "
            + ("not measured" if None in devs else f"{sum(devs) / n:.5f} ms")
            + f", bound {b_ms:.5f} ms ({b_by}), resid_plain "
            f"{means[bpc][1]:.4f} ms")
    kernels = []
    # the itx entry's times and bound: the 8-bit intra pictures' means
    for name, replaces, n_launch, err, ms, pms, nbytes, ops in (
        ("itx", "rav1d_tpu/ops/pallas/itx_all.py:110", launches, worst,
         *means[8]),
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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())  # again here, where the end of a long log keeps it
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
