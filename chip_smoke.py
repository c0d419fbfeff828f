"""Drive rav1d_tpu_torch's intra and inter paths once on a CUDA card, end
to end.

    python3 chip_smoke.py

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
3. slice: seeded 1920x1080 synthetic AV1 still pictures
   (rav1d_tpu_torch/synth.py): the port's host path (Decoder(host_path=
   True)) must give the committed digests
   (rav1d_tpu_torch/smoke_digests.json); on each frame's blob, packed from
   a capture of that decode, the residual program (one itx launch) must
   equal resid_plain; then each picture decodes through
   rav1d_tpu_torch.Decoder(device="cuda") to the host path's MD5, every
   frame on the engine, no fallback, exactly one itx launch per frame and
   no call of the plain transforms (engine/kernels.py itx_any_core,
   wht_core);
4. timing: on the same blobs, the frame launch and resid_plain (CUDA
   events), and torch.profiler windows over resid calls and over each
   class of the frame launched alone, which give the kernel's device time
   apart from its launch;
5. inter: a seeded 1920x1080 synthetic inter sequence (synth.
   inter_sequence: a key frame and two inter frames with every inter tool
   of 4:2:0) must give the committed digests on the host path; on each
   frame's blob the residual program must equal resid_plain; then it
   decodes through one Decoder(device="cuda") to the same MD5s, frame by
   frame, with no fallback, no upload of a host reference plane (every
   reference is the engine's own device output), exactly one itx launch
   per frame and no call of the plain transforms; every inter slot but
   segy00/segy10 (4:2:2 and 4:4:4 only) must carry tiles, and interintra
   wave items must be present;
6. idct8x8: the 8x8 DCT_DCT batch (ops/itx8.py; on no decoder path): its
   entry point driven once at N=16384 with the launch count reset before
   and read after, then the kernel against idct8x8_batch_plain,
   bit-identical at N=256 for bpc 8/10/12 (1/8 of the blocks full-range
   int32) and at N=16384, where both are timed;
7. vectors: where $RAV1D_TEST_DATA names a dav1d-test-data directory,
   two conformance streams against their meson MD5s, and the first 16
   frames of the bench's inter stream against the port's host path, with
   no fallback.
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
BENCH_STREAM, BENCH_FRAMES = "8-bit/data/00000627.ivf", 16
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


def host_decode(data):
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth

    t0 = time.perf_counter()
    md5 = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), [data])
    return md5, (time.perf_counter() - t0) * 1e3


def slice_phase(dev):
    """The main path: synthetic 1080p pictures through the port. Returns
    (itx launches, max |err| of ra against resid_plain, the frames' blobs
    as (seed, dev, hdr, tx_valid, ah, aw))."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import kernels, run
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import itx as I

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    if (digests["width"], digests["height"]) != (W, H):
        raise AssertionError("smoke_digests.json is for another picture size")
    streams = [synth.still_picture(W, H, s) for s in SEEDS]
    oracle = []
    frames = []
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
        frames.append(fp)
        log("  features " + json.dumps(synth.features(*fp)))

    # the residual program on each frame's blob against its plain version;
    # this also brings the caching allocator to the frame's buffer sizes, so
    # the decodes below read steady-state stage times (a process's first
    # frame of a size otherwise pays cudaMalloc for its buffers)
    worst = 0
    blobs = []
    for s, (f, plan) in zip(SEEDS, frames):
        pk = pack_frame(f, plan)
        ah, aw = plan.ah, plan.aw
        d, _ = Uploader(dev).upload(pk, ah * aw, 8)
        ra = P.resid(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=8)[0]
        ref = P.resid_plain(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=8)[0]
        torch.cuda.synchronize()
        worst = max(worst, max_err(ra, ref))
        if not torch.equal(ra, ref):
            raise AssertionError(f"seed {s}: resid (itx kernel) != resid_plain")
        blobs.append((s, d, pk.hdr, pk.tx_valid, ah, aw))
    log(f"resid (one itx launch) == resid_plain on the {len(blobs)} frames' "
        "blobs")

    # warm-up (CUDA context, lazy module loads) on a small picture
    synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False), device=dev),
                      [synth.still_picture(256, 128, 7)])
    torch.cuda.synchronize()

    T.engine.stats.update(frames=0, fallback=0)
    I.launches = 0
    kernels.calls = 0
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
    plain_calls = kernels.calls
    stats = dict(T.engine.stats)

    for s, st, ms, g, o in zip(SEEDS, stages, wall, got, oracle):
        log(f"port seed {s} {W}x{H}: {ms:.1f} ms wall  md5 {g[0]}  "
            f"{'==' if g == o else '!='} host")
        log("  stage_ms " + json.dumps({k: round(v, 3) for k, v in st.items()}))
    log(f"engine stats {stats}  itx launches {launches}  plain transform "
        f"calls {plain_calls}")
    if got != oracle:
        raise AssertionError("port output differs from the host path")
    if stats["frames"] != len(streams) or stats["fallback"] != 0:
        raise AssertionError(f"engine did not decode every frame: {stats}")
    if launches != len(streams):
        raise AssertionError(f"{launches} itx launches for {len(streams)} "
                             "frames: the main path must launch once a frame")
    if plain_calls:
        raise AssertionError(f"{plain_calls} plain transform calls on the card")

    return launches, worst, blobs


def inter_phase(dev):
    """The inter path: synth.inter_sequence at 1080p through one Decoder on
    the card. Returns the itx launches of its decode."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import kernels, run
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.layout import SLOTS
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import itx as I

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        want = json.load(fh)["inter"]
    packets = synth.inter_sequence(W, H, want["seed"])
    t0 = time.perf_counter()
    host = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), packets)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"inter host path seed {want['seed']} {W}x{H}, {len(packets)} "
        f"frames: {host_ms:.1f} ms  md5 {host}  "
        f"{'==' if host == want['md5'] else '!='} committed digests")
    if host != want["md5"]:
        raise AssertionError("inter host path differs from the committed "
                             "digests")
    frames = synth.capture_frames(packets)
    tiles = dict.fromkeys(SLOTS, 0)
    ii = 0
    for i, fp in enumerate(frames):
        ft = synth.features(*fp)
        line = {k: ft[k] for k in ("items", "waves")}
        if "inter_tiles" in ft:
            for k, v in ft["inter_tiles"].items():
                tiles[k] += v
            ii += ft["ii_items"]
            line.update((k, ft[k]) for k in ("inter_tiles", "ii_items",
                                             "pool_rows", "lap_rows",
                                             "pool_cap"))
        log(f"  inter frame {i} features " + json.dumps(line))
    empty = sorted(k for k, v in tiles.items() if not v and k not in NOT_420)
    if empty or not ii:
        raise AssertionError(f"inter slots without tiles {empty}, "
                             f"interintra items {ii}")

    # the residual program on each frame's blob against its plain version
    # (and the allocator brought to the frame's buffer sizes)
    for i, (f, plan) in enumerate(frames):
        pk = pack_frame(f, plan)
        ah, aw = plan.ah, plan.aw
        d, _ = Uploader(dev).upload(pk, ah * aw, 8)
        ra = P.resid(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=8)[0]
        ref = P.resid_plain(d, pk.hdr, pk.tx_valid, ah=ah, aw=aw, bpc=8)[0]
        torch.cuda.synchronize()
        if not torch.equal(ra, ref):
            raise AssertionError(f"inter frame {i}: resid != resid_plain")
    log(f"resid (one itx launch) == resid_plain on the {len(frames)} inter "
        "sequence frames' blobs")

    T.engine.stats.update(frames=0, fallback=0, ref_uploads=0)
    I.launches = 0
    kernels.calls = 0
    dec = T.Decoder(T.Settings(apply_grain=False), device=dev)
    got = []
    for i, data in enumerate(packets):  # frame by frame: stage_ms per frame
        run.reset_stats()
        t0 = time.perf_counter()
        got += synth.decode_md5s(dec, [data])
        ms = (time.perf_counter() - t0) * 1e3
        log(f"port inter frame {i} {W}x{H}: {ms:.1f} ms wall  md5 {got[-1]}  "
            f"{'==' if got[-1] == host[i] else '!='} host")
        log("  stage_ms " + json.dumps({k: round(v, 3)
                                        for k, v in run.stage_ms.items()}))
    launches = I.launches
    plain_calls = kernels.calls
    stats = dict(T.engine.stats)
    log(f"inter engine stats {stats}  itx launches {launches}  plain "
        f"transform calls {plain_calls}")
    if got != host:
        raise AssertionError("port inter output differs from the host path")
    if stats["frames"] != len(packets) or stats["fallback"]:
        raise AssertionError(f"engine did not decode every frame: {stats}")
    if stats["ref_uploads"]:
        raise AssertionError("a reference plane was uploaded from the host")
    if launches != len(packets):
        raise AssertionError(f"{launches} itx launches for {len(packets)} "
                             "frames: the main path must launch once a frame")
    if plain_calls:
        raise AssertionError(f"{plain_calls} plain transform calls on the card")
    inter_timing(dev, frames)
    return launches


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
    """On each frame's blob: the itx frame launch (CUDA events, host launch
    included; and its device time from torch.profiler), the whole resid
    program and resid_plain. Returns per-frame means (launch ms, device ms
    or None, plain ms, bytes, operations)."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.layout import SIZES
    from rav1d_tpu_torch.ops.cuda import itx as I

    rows = []
    for s, d, hdr, tv, ah, aw in blobs:
        ra = torch.zeros(6 * ah * aw, dtype=torch.int32, device=d.device)
        k_ms = cuda_ms(lambda: I.itx_frame(d, hdr, tv, ra, aw, 8), 50)
        dev_ms = profiled_kernel_ms(
            lambda: P.resid(d, hdr, tv, ah=ah, aw=aw, bpc=8), "itx_frame_kernel",
            10)
        r_ms = cuda_ms(lambda: P.resid(d, hdr, tv, ah=ah, aw=aw, bpc=8), 20)
        p_ms = cuda_ms(lambda: P.resid_plain(d, hdr, tv, ah=ah, aw=aw, bpc=8), 3)
        nbytes, ops = itx_frame_work(d.cpu().numpy(), hdr, tv, 8)
        b_ms, b_by = bound(nbytes, ops)
        dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.5f} ms"
        log(f"itx frame seed {s}: {sum(tv.values())} blocks in {len(tv)} "
            f"classes; launch {k_ms:.5f} ms (CUDA events), kernel device "
            f"time {dev_txt} (torch.profiler), resid {r_ms:.5f} ms, "
            f"resid_plain {p_ms:.4f} ms; {nbytes} bytes, {ops} ops, bound "
            f"{b_ms:.5f} ms ({b_by})")
        rows.append((k_ms, dev_ms, p_ms, nbytes, ops))
        # each class of the frame alone: a launch over its part of the table
        per = []
        for key in [k for k in list(range(len(SIZES))) + ["wht"] if k in tv]:
            n = tv[key]
            name = "wht" if key == "wht" else "%dx%d" % SIZES[key]
            ms = profiled_kernel_ms(
                lambda: I.itx_frame(d, hdr, {key: n}, ra, aw, 8),
                "itx_frame_kernel", 5)
            per.append(f"{name} {n}: "
                       + ("not measured" if ms is None else f"{ms:.5f}"))
        log(f"  seed {s} device ms per class alone (blocks: ms): "
            + "; ".join(per))
    mean = [sum(r[i] for r in rows) / len(rows) for i in (0, 2, 3, 4)]
    devs = [r[1] for r in rows]
    dev_mean = None if None in devs else sum(devs) / len(devs)
    return mean[0], dev_mean, mean[1], mean[2], mean[3]


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
    bench_stream_phase(dev, d)


def bench_stream_phase(dev, d):
    """The first BENCH_FRAMES frames of the bench's inter stream, frame by
    frame against the port's host path, with no fallback."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    path = os.path.join(d, BENCH_STREAM)
    if not os.path.exists(path):
        log(f"vector phase: {BENCH_STREAM} not found; skipped")
        return
    host = T.Decoder(T.Settings(apply_grain=False), host_path=True)
    packets, want = [], []
    for pkt in IvfDemuxer(path):
        if len(want) >= BENCH_FRAMES:
            break
        packets.append(pkt.data)
        want += synth.decode_md5s(host, [pkt.data])
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device=dev), packets)
    fb = T.engine.stats["fallback"] - before["fallback"]
    log(f"vector {BENCH_STREAM}: {len(got)} frames, "
        f"{sum(a == b for a, b in zip(got, want))} equal to the host path, "
        f"fallback {fb}")
    if got != want or fb:
        raise AssertionError(f"{BENCH_STREAM}: differs from the host path "
                             f"or fell back ({fb})")


def main():
    import torch

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
    launches, worst_main, blobs = slice_phase(dev)
    k_ms, dev_ms, p_ms, itx_bytes, itx_ops_n = timing_phase(blobs)
    worst = max(worst, worst_main)
    launches += inter_phase(dev)
    i8 = idct8x8_phase(dev)
    vector_phase(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = sorted(m for m in sys.modules
                 if m == "rav1d_tpu" or m.startswith("rav1d_tpu."))
    if ref:
        raise AssertionError(f"modules of rav1d_tpu were imported: {ref}")

    b_ms, b_by = bound(itx_bytes, itx_ops_n)
    log(f"itx per frame (mean of {len(blobs)}): launch {k_ms:.5f} ms, device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.5f} ms'}, "
        f"bound {b_ms:.5f} ms ({b_by}), resid_plain {p_ms:.4f} ms")
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
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
