"""Drive rav1d_tpu_torch's intra and inter paths, at every bit depth and
chroma layout and with superres, once on a CUDA card, end to end.

    python3 chip_smoke.py [--test-data DIR] [--only uhd]

Phases (any failure exits non-zero before the last line; `--only uhd`
runs the set-up and phase 6 alone):
1. set-up: build the hand-written kernels (csrc/itx.cu: the itx frame
   kernel and the 8x8 DCT_DCT kernel; csrc/wave.cu: the intra wavefront's
   frame kernel, its barrier-only twin and the level kernel; csrc/inter.cu:
   the inter program's batched kernel, its earlier per-tile form and both
   traced builds; csrc/lf.cu, cdef.cu, superres.cu and lr.cu: the post
   filters' deblock, CDEF, superres upscale, Wiener and self-guided
   kernels (one launch a frame, and the earlier one a plane); nvcc,
   sm_90a, one process per source, all started together) and print
   ptxas's registers, stack frames and spills. The port's native syntax library
   (csrc/host/, built into rav1d_tpu_torch/build/ when the port is
   imported) must have loaded: a decode on the Python syntax anchor would
   change every host number;
2. kernel: the itx kernel, through its per-size entry points (ops/cuda/
   itx.py itx and wht), against the plain torch versions on the card, all
   19 tx sizes and the WHT x bpc 8/10/12, N=1000 random int32 blocks
   including extreme values; and each filter kernel, through its wrapper
   (ops/cuda/filters.py), against its plain pass (engine/filters.py) on
   random planes, maps and stripes in hand-built blobs at 8, 10 and 12
   bits and in 4:0:0 (deblock, CDEF, Wiener and the self-guided filter
   through both their forms),
   and the superres kernel against programs._superres (resize_plane)
   on random planes at 8, 10 and 12 bits in every layout at denominators
   9-16 (filter_kernel_phase); bit-identical required;
Each stream of phases 3-8 runs through stream_on_card: the port's host
path (Decoder(host_path=True), captured) must give the committed digests
(rav1d_tpu_torch/smoke_digests.json) where there are some; on each engine
frame's blob, packed from that capture, the residual program (one itx
launch) must equal resid_plain, on each engine inter frame the inter
program (one launch of the inter kernel) must equal inter_plain, and the
wave program (one launch of the wave frame kernel) and its per-level form
(one launch of the level kernel per level with items) must both equal
wave_plain on the same input (zero planes, or the inter program's on an
inter frame; at 1080p only on still
seed 1, inter frame 1 and the 12-bit 4:4:4 still, whose plain wavefront
takes 10-30 s each), and on every engine frame filter_ (the filter
kernels: two deblock launches, one CDEF launch, one Wiener launch and
one self-guided launch where any plane has such stripes, one superres
launch on a superres frame) must equal filter_plain
on the wave program's output,
planes and packed output; then one
rav1d_tpu_torch.Decoder(device="cuda") at
frame delay 1 decodes the stream frame by frame to the host path's MD5s
with no fallback but the planner's own, no upload of a host reference
plane (every reference is the engine's own device output), exactly one itx
launch per engine frame, one inter launch per engine inter frame (and none
of the earlier inter form), one wave
frame launch per engine frame with wave items and no level launch, exactly
those filter launches per engine frame, and no call of the plain
transforms (engine/kernels.py itx_any_core, wht_core), of inter_plain
(programs.inter_plain_calls), of the plain wave step (engine/wave.py
class_step) or of the plain filter passes (engine/filters.py calls),
printing per-frame stage_ms and the wall time
the stages leave (the host front end and the planner). At 1080p, per
frame: the wave program through each entry alone (CUDA events), the device
time of all its kernels and of the frame kernel, or of the level kernel's
launches (torch.profiler), per level, the barrier-only floor of the frame
kernel (the same grid, level walk and barriers, no item work) and the
floor of an empty kernel launched as the level kernel is over the same
levels, the bound (wave_work), and the traced frame kernel's per-level
phases in clock cycles (wave_trace); and the filter program alone:
filter_ and filter_plain in turns (CUDA events), the device time of each
filter kernel (torch.profiler) and of its launches alone (CUDA events),
each plain pass's time, and each kernel's bound (filter_work); on a
superres frame also the upscale through one torch.matmul per plane by its
banded resampling matrix (the library time); and deblock by direction,
CDEF, Wiener and the self-guided filter through the decoder path's kernels
(rav1d_deblock, rav1d_cdef, rav1d_lr_wiener_frame, rav1d_lr_sgr_frame)
and their earlier forms (rav1d_lf_pass, rav1d_cdef_frame, rav1d_lr_wiener
and rav1d_lr_sgr a plane), each stage's input from filter_plain (the loop
restoration launches' from filter_kernels, the Wiener outcome each
plane's lr_wiener_pass, the self-guided one filter_plain's): new ==
earlier == the plain stage, and each
form's device time (torch.profiler, each direction's launches alone in
their own windows) and its launches alone (CUDA events), in turns, beside
the stage's bound (filter_forms). On each 1080p inter frame the inter
program through the new kernel (rav1d_inter_batches) and the earlier one
(rav1d_inter_frame): new == earlier == inter_plain, each form's program
with its host call (CUDA events) and its device time (torch.profiler,
every timed call on fresh zero planes), in turns, the bound (inter_work),
the host side of programs.inter part by part (inter_host_split) and both
forms' traced phases in clock cycles (inter_trace).
3. slice: seeded 1920x1080 synthetic AV1 still pictures
   (rav1d_tpu_torch/synth.py), after a small picture's decode, and a
   1920x1080 superres still (coded 1707 columns wide), whose filter
   program is timed (no wave_plain on it);
4. inter: a seeded 1920x1080 synthetic inter sequence (synth.
   inter_sequence: a key frame and two inter frames with every inter tool
   of 4:2:0); every inter slot but segy00/segy10 (4:2:2 and 4:4:4 only)
   must carry tiles, and interintra wave items must be present; then the
   inter program alone on each inter frame's blob through both forms of
   the inter kernel in turns and through inter_plain (CUDA events;
   torch.profiler's device times), beside its bound (inter_work), with the
   host side's parts and both forms' traced phases (inter_timing); the
   10-bit inter frames of phase 5 likewise;
5. high bit depth: the committed 1080p streams of smoke_digests.json
   "formats": a 10-bit 4:2:0 key + two inter frames and a 12-bit 4:4:4
   picture, whose blobs hold word coefficients (the itx kernel's 10/12-bit
   branch);
6. 2160p (uhd_phase): the committed 3840x2160 streams of
   smoke_digests.json "uhd", a 10-bit 4:2:0 still in one tile (the format
   of the JAX bench's 4k_10bit_intra) and an 8-bit key frame and two
   inter frames in four tile columns, captured on the engine (its decode
   held to the digests), with the checks of phases 3-5 on every frame
   (wave_plain on the still only) and each frame's own launches; on the
   still and the first inter frame each of the seven kernels' device time
   a launch (the median of five torch.profiler windows, with the launches
   each saw), its plain version and its bound, the wave kernel's
   barrier-only floor, the upload's zero fill and copy alone; in the
   decodes the host side (the staging wait, write_into, the wave span's
   host call, garbage collections);
7. formats: at 640x360, still pictures at 8, 10 and 12 bits in 4:0:0,
   4:2:2 and 4:4:4, 10-bit inter sequences in 4:2:2 (segy10 must carry
   tiles), 4:4:4 (segy00) and 4:0:0, and an 8-bit superres inter sequence,
   whose fourth frame the planner sends to the host path (scaled
   references);
8. headers: at 640x360, an 8-bit and a 10-bit sequence with the header
   tools of synth.Tools on (2x2 tiles, segmentation with a lossless
   segment, so the frame blobs carry WHT blocks, delta q and delta lf,
   loop filter deltas, TX_MODE_LARGEST with the reduced transform set;
   128-px superblocks in the 8-bit one, 64-px LR units in the 10-bit
   one), no frame falling back;
9. residual: the multi-device residual (parallel/resid.py) on an NCCL
   process group of one rank (file:// init) over the first still
   picture's captured coefficient store: sharded_residual_plane, one itx
   launch per non-WHT size group and no plain transform call, must equal
   single_device_residual_plane (the plain transforms on the card); both
   timed with CUDA events beside the frame's resid program;
10. CLI: rav1d_tpu_torch.cli.main(["-i", <a 640x360 IVF file of an 8-bit
   inter sequence>, "--verify", <its host-path MD5>, "--frametimes",
   <file>]) in process must return 0, with one itx launch per frame; the
   per-frame times are printed (the decode also makes one inter launch
   per inter frame and no inter_plain call, one wave frame launch per
   frame with wave items, no level launch and no class_step call, and its
   filter launches; each of its filter_ calls, recorded, must equal
   filter_plain, and each of its inter programs inter_plain);
11. pipeline: the frame ring (pipeline_phase): the 1080p 8-bit and 10-bit
   inter sequences, the 8-bit 640x360 header-tools sequence (2x2 tiles),
   the 640x360 superres sequence (its fourth frame falls back to the host
   path and reads engine-decoded references on the ring's worker) and a
   640x360 intrabc sequence, each at delays 2 and 3 under
   torch.cuda.set_sync_debug_mode("error"), must equal delay 1: MD5s,
   fallback frames, engine stats and launch counts (the filter kernels'
   too, the superres kernel's with them; every filter_ call of delays 1, 2
   and 3, recorded on the worker,
   must equal filter_plain, and every inter program call inter_plain;
   one inter launch per inter program call and no inter_plain call in the
   decode). Then the 1080p inter
   sequence's packets three times over (9 units) at delays 1, 2, 3 and 1,
   and at delay 2 with the interpreter's switch interval at 0.5 ms: per
   run the stream's wall and mean per frame, the caller's thread's time
   in send_data, the syntax pass and get_picture, the dense passes' time
   (the worker's busy time) with the planner's and pack's shares, and the
   CUDA-event stages; then, on a machine with two cards or more, the
   640x360 inter sequence decoded on cuda:1 at delay 1 while card 0 is
   current, to the host path's MD5s (second_card_phase);
12. timing: on the blobs of phases 3 and 5, the frame launch and
   resid_plain (CUDA events), and torch.profiler windows over resid calls
   and over each class of the frame launched alone, which give the
   kernel's device time apart from its launch;
13. idct8x8: the 8x8 DCT_DCT batch (ops/itx8.py; on no decoder path): its
   entry point driven once at N=16384 with the launch count reset before
   and read after, then the kernel against idct8x8_batch_plain,
   bit-identical at N=256 for bpc 8/10/12 (1/8 of the blocks full-range
   int32) and at N=16384, where both are timed;
14. vectors: with `--test-data DIR` naming a dav1d-test-data directory,
   two conformance streams against their meson MD5s, and the first frames
   of the bench's inter stream (16) and of its 10-bit stream
   318_tx_4x4.ivf (8, bench.py's frame limit) against the port's host
   path, with no fallback.
Every decode must make no class_step and no inter_plain call, and each,
but for the whole conformance streams of the vector phase, one wave frame
launch per frame with wave items and no level launch, one inter launch
per engine inter frame and none of its earlier form, and its frames'
filter launches with no launch of the earlier deblock, CDEF, Wiener and
self-guided forms and no plain filter call. The earlier filter forms then
run once on their own over still seed 1's filter input, and the earlier
inter form over the 1080p inter frame 1, their launch counts reset
before and read after (their JSON entries' launches).
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

import contextlib
import functools
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
# the wave kernels across the run: frame launches in the decodes, frames
# compared with wave_plain and the largest difference of the frame kernel
# and of the level kernel, per-frame timings by label
WAVE = {"launches": 0, "compared": 0, "err": 0, "err_levels": 0, "rows": {}}


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
    a small picture (CUDA context, lazy module loads); then a 1080p
    superres still (seed 1 coded at 8/9 of its width), held to the host
    path, its filter program timed (FILT["sr_main"] its row's label).
    Returns (itx launches, max |err| of ra, the stills' blobs, the first
    picture's captured [(f, plan)])."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    if (digests["width"], digests["height"]) != (W, H):
        raise AssertionError("smoke_digests.json is for another picture size")
    from rav1d_tpu_torch.engine import wave as TW
    from rav1d_tpu_torch.ops.cuda import wave as WK

    warm = [synth.still_picture(256, 128, 7)]
    nframes = wave_frames(synth.capture_frames(warm))
    TW.calls = WK.launches = WK.level_launches = 0
    reset_filter_counts()
    with FilterRecorder() as rec:
        synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False),
                                    device=dev), warm)
    torch.cuda.synchronize()
    if TW.calls or WK.launches != nframes or WK.level_launches:
        raise AssertionError(f"the warm-up decode: {TW.calls} class_step "
                             f"calls, {WK.launches} wave frame launches for "
                             f"{nframes} frames, {WK.level_launches} level "
                             "launches")
    check_filter_counts("the warm-up decode", filter_counts(),
                        filter_want(rec.check("the warm-up decode")))
    launches = worst = 0
    blobs, captured = [], []
    for s in SEEDS:
        n, err, frames = stream_on_card(dev, f"still seed {s} {W}x{H}",
                                        [synth.still_picture(W, H, s)],
                                        want=[digests["md5"][str(s)]],
                                        blobs=blobs,
                                        wave_check=(0,) if s == 1 else (),
                                        time_wave=True)
        launches += n
        worst = max(worst, err)
        captured.append(frames)
    label = f"still superres {W}x{H}"
    n, err, frames = stream_on_card(dev, label, [synth.still_picture(
        W, H, 1, superres=True)], wave_check=(), time_filter=True)
    (f, plan), = frames
    if plan is None or f.cur.w != 1707 or f.sr_cur.w != W:
        raise AssertionError(f"{label}: not an engine frame coded 1707 "
                             "columns wide")
    FILT["sr_main"] = f"{label} frame 0"
    return launches + n, max(worst, err), blobs, captured[0]


def wave_frames(frames):
    """The engine frames of captured [(f, plan)] with wave items: the wave
    frame launches their decode makes."""
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import wave as WK

    return sum(bool(WK.levels(pack_frame(f, plan).waves))
               for f, plan in frames if plan is not None)


def levels_program(planes, ra, d, pk, kw):
    """programs.wave through the level kernel: the palette scatter, then
    ops/cuda/wave.py wave_levels (one launch per level with items)."""
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import wave as WK

    ah, aw = kw["ah"], kw["aw"]
    pf = P.palette_pf(planes, d, pk.hdr)
    WK.wave_levels(pf, ra, d, pk.hdr, pk.waves, **wave_kw(kw))
    return pf[: 3 * ah * aw].view(3, ah, aw)


def wave_kw(kw):
    """The wave wrappers' keywords from wave_input's."""
    return dict(aw=kw["aw"], psz=kw["ah"] * kw["aw"], bpc=kw["bpc"],
                ss_hor=kw["ss_hor"], ss_ver=kw["ss_ver"])


def inter_phase(dev):
    """The inter path: synth.inter_sequence at 1080p through
    stream_on_card, held to its committed digests, with every inter slot
    but segy00/segy10 (4:2:2 and 4:4:4 only) carrying tiles and interintra
    wave items present; the inter program alone on each inter frame's blob
    (inter_timing). Returns (itx launches, max |err| of ra)."""
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine.layout import SLOTS

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        want = json.load(fh)["inter"]
    label = f"inter seed {want['seed']} {W}x{H}"
    INTER["main"] = f"{label} frame 1"  # the kernels line's frame
    launches, worst, _ = stream_on_card(
        dev, label,
        synth.inter_sequence(W, H, want["seed"]), want=want["md5"],
        slots=[k for k in SLOTS if k not in NOT_420], interintra=True,
        wave_check=(1,), time_wave=True, time_inter=True)
    return launches, worst


# the inter kernel across the run: launches in the decodes, engine inter
# frames held to inter_plain and their largest difference, per-frame
# timings by label
INTER = {"launches": 0, "compared": 0, "err": 0, "rows": {}}


def inter_frames(frames):
    """The engine inter frames of captured [(f, plan)]: the inter launches
    their decode makes."""
    return sum(plan is not None and plan.inter is not None
               for _, plan in frames)


def inter_inputs(f, plan, pk, d):
    """(reference stacks, keywords) of the inter program on a frame's
    blob."""
    from rav1d_tpu_torch.engine.run import stack_planes
    from rav1d_tpu_torch.headers import PixelLayout as PL

    sh = 0 if f.cur.layout == PL.I444 else 1
    sv = 1 if f.cur.layout == PL.I420 else 0
    out = f.sr_cur
    ach, acw = out.u.shape if out.u is not None else (0, 0)
    stacks = (stack_planes(pk.srcs[0], d.device, (plan.ah, plan.aw)),
              stack_planes(pk.srcs[1], d.device, (ach, acw)))
    return stacks, dict(ah=plan.ah, aw=plan.aw, bpc=f.cur.bpc, vwY=f.cur.w,
                        vhY=f.cur.h, vwC=(f.cur.w + sh) >> sh,
                        vhC=(f.cur.h + sv) >> sv)


# least 32-bit operations per 8x8 tile (all 64 cells; inter_work scales
# them by the cells a tile writes): the taps' multiplies and adds (16 a
# value), rounding adds and shifts (2), clamps (2), int16 wraps (3), the
# prep bias (1), a warp value's filter index (9), the blends' multiplies,
# adds and shifts
_PUT_OPS = {0: 120 * 21 + 64 * 20, 1: 64 * 20, 2: 64 * 20, 3: 0,
            4: 72 * 9 + 64 * 8}
_PREP_OPS = {0: 120 * 21 + 64 * 22, 1: 64 * 22, 2: 64 * 22, 3: 64 * 5}
_WARP_OPS = 120 * 30 + 64 * 29  # the prep's rounding costs the same
_COMB_OPS = {"avg": 64 * 8, "segy00": 64 * 14, "segy10": 64 * 14 + 32 * 3,
             "segy11": 64 * 14 + 16 * 6, "mask": 64 * 11, "seguv": 64 * 11,
             "blend": 64 * 6}
# the source window of each put and prep case (rows x columns)
_WINDOW = {0: 15 * 15, 1: 8 * 15, 2: 15 * 8, 3: 8 * 8, 4: 9 * 9}


def inter_work(pk, g):
    """(bytes, operations) of a frame's inter program, each input read
    once and each output written once: the input planes, the residuals
    added and the output planes (int32), each tile's descriptor and source
    window (reference pixels of 1 byte at 8 bits, 2 above) and its masks
    (int32); the pools are the program's own intermediates. Operations per
    tile from _PUT_OPS .. _COMB_OPS, scaled by the cells it writes, and 3 a
    pixel for the residual add (an add, a clip)."""
    import numpy as np

    from rav1d_tpu_torch.engine import layout as L
    from rav1d_tpu_torch.ops.cuda import inter as IK

    words = pk.words()
    psz = g["ah"] * g["aw"]
    es = 1 if g["bpc"] == 8 else 2
    nbytes, ops = 3 * 3 * psz * 4, 3 * 3 * psz
    for name, runs in pk.inter_runs.items():
        rows = IK.ROWS[name]
        if name.startswith(("warp", "wprep")):
            twth = (L.W_TW, L.W_TH)
        elif name == "blend":
            twth = (L.B_TW, L.B_TH)
        elif rows == L.NCOMB:
            twth = (L.C_TW, L.C_TH)
        else:
            twth = (L.D_TW, L.D_TH)
        for r in runs:
            nbytes += 4 * rows * r.n  # the descriptors (host tiles' words)
            if name == "hostpool":
                continue
            base = (int(pk.hdr[L.INTER0 + 2 * L.SLOTS[name]])
                    + r.c0 * rows * L.TB)
            d = words[base : base + r.nc * rows * L.TB].reshape(r.nc, rows,
                                                                L.TB)
            d = d.transpose(1, 0, 2).reshape(rows, -1)[:, : r.n]
            cells = int((np.clip(d[twth[0]], 0, 8)
                         * np.clip(d[twth[1]], 0, 8)).sum())
            if name.startswith(("put", "lap")):
                nbytes += es * _WINDOW[r.case] * r.n
                ops += _PUT_OPS[r.case] * cells // 64
            elif name.startswith("prep"):
                nbytes += es * _WINDOW[r.case] * r.n
                ops += _PREP_OPS[r.case] * cells // 64
            elif name.startswith(("warp", "wprep")):
                nbytes += es * 225 * r.n
                ops += _WARP_OPS * cells // 64
            else:  # masks: the wedge's 64 words, the blend's 8
                nbytes += 4 * r.n * {"mask": 64, "blend": 8}.get(name, 0)
                ops += _COMB_OPS[name] * cells // 64
    return nbytes, ops


def fresh(make, n):
    """A call that hands each of its n calls a new copy of make()'s tensor,
    all made before the first (a timed launch then never reads what an
    earlier one wrote)."""
    bufs = iter([make() for _ in range(n)])
    return lambda fn: fn(next(bufs))


def inter_timing(label, f, plan, pk, d, ra):
    """The inter program alone on a frame's blob, through the new form
    (programs.inter: ops/cuda/inter.py inter_frame), the earlier form
    (inter_kernels over inter_frame_earlier) and inter_plain: new ==
    earlier == plain on zero planes; then the forms in turns (new,
    earlier, earlier, new, twice): each program with its host call (CUDA
    events) and its kernel's device time (torch.profiler: the mean per
    launch; the median of the four readings, as a window now and then
    reads low), every timed call on a fresh copy of the zero planes; inter_plain's
    time and device time; the bound (inter_work); what the zero phase
    stands in for (a zero fill of the pools at the packer's limit); the
    new form's host side part by part (inter_host_split); and each form's
    traced phases (inter_trace). Returns a dict of them."""
    import types

    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import inter as IK

    (sY, sC), g = inter_inputs(f, plan, pk, d)

    def zeros():
        return torch.zeros((3, plan.ah, plan.aw), dtype=torch.int32,
                           device=d.device)

    args = (ra, d, pk.hdr, pk.inter_runs, sY, sC)
    earlier = types.SimpleNamespace(inter_frame=IK.inter_frame_earlier)
    forms = {"new": lambda x: P.inter(x, *args, **g),
             "earlier": lambda x: P.inter_kernels(x, *args, k=earlier, **g)}
    names = {"new": "inter_batch_kernel", "earlier": "inter_frame_kernel"}
    want = P.inter_plain(zeros(), *args, **g)
    n0 = (IK.launches, IK.earlier_launches)
    for form, run in forms.items():
        err = max_err(run(zeros()), want)
        INTER["err_" + form] = max(INTER.get("err_" + form, 0), err)
        if err:
            raise AssertionError(f"inter {label}: the {form} form != "
                                 f"inter_plain (max |err| {err})")
    ms = {form: [] for form in forms}
    dev = {form: [] for form in forms}
    for form in ("new", "earlier", "earlier", "new") * 2:
        call = fresh(zeros, 11)
        ms[form].append(cuda_ms(lambda: call(forms[form]), 10))
        call = fresh(zeros, 26)
        dev[form].append(profiled_names_ms(
            lambda: call(forms[form]), 5, [names[form]],
            {names[form]: 1})[1][names[form]])
    call = fresh(zeros, 3)
    pms = [cuda_ms(lambda: call(lambda x: P.inter_plain(x, *args, **g)), 2)]
    call = fresh(zeros, 3)
    p_dev = profiled_device_ms(
        lambda: call(lambda x: P.inter_plain(x, *args, **g)), 2)[0]
    words = 2 * IK.pool_rows(plan.ah, plan.aw) * 64 + plan.ah * plan.aw
    fill_ms = cuda_ms(lambda: torch.zeros(words, dtype=torch.int32,
                                          device=d.device), 10)
    nbytes, ops = inter_work(pk, g)
    b_ms, b_by = bound(nbytes, ops)
    tiles = {k: sum(r.n for r in v) for k, v in pk.inter_runs.items()}
    host = inter_host_split(f, plan, pk, d, ra)
    traces = {}
    for form, which in (("earlier", IK.EARLIER_TRACE), ("new", IK.NEW_TRACE)):
        rows = IK.pool_rows(plan.ah, plan.aw)
        sc = [torch.empty(rows * 64, dtype=torch.int32, device=d.device)
              for _ in range(2)]
        sc.append(torch.empty(plan.ah * plan.aw, dtype=torch.int32,
                              device=d.device))
        clk = IK.trace_frame(zeros(), *args, *sc, form=form, **g)
        traces[form] = inter_trace(pk, clk, 8 * IK.grid(which),
                                   3 * plan.ah * plan.aw)
    # the launches here are outside the decodes, whose counts are reset
    IK.launches, IK.earlier_launches = n0

    def txt(v, fmt="%.4f ms"):
        return "not measured" if v is None else fmt % v

    def pair(v):
        return "/".join(txt(x, "%.4f") for x in v) + " ms"

    log(f"  inter {label}: {sum(tiles.values())} tiles; new == earlier == "
        f"inter_plain; programs.inter with its host call (CUDA events, in "
        f"turns) new {pair(ms['new'])}, earlier {pair(ms['earlier'])}; "
        f"device (torch.profiler) inter_batch_kernel {pair(dev['new'])}, "
        f"inter_frame_kernel {pair(dev['earlier'])}; inter_plain "
        f"{pms[0]:.3f} ms, device {txt(p_dev, '%.3f ms')}; bound "
        f"{b_ms:.5f} ms ({b_by}: {nbytes} bytes, {ops} ops); a zero fill "
        f"of the pools ({4 * words} bytes) {fill_ms:.4f} ms")
    log(f"  inter {label} host side of programs.inter (perf_counter, ms a "
        f"call): {json.dumps(host)}")
    for form, tr in traces.items():
        log(f"  inter {label} trace, {form} form (clock64 cycles per block): "
            + json.dumps(tr))

    def median(v):
        got = sorted(x for x in v if x is not None)
        n = len(got)
        return None if not n else (got[(n - 1) // 2] + got[n // 2]) / 2

    return dict(ms=median(ms["new"]), ms_earlier=median(ms["earlier"]),
                k_ms=median(dev["new"]), k_earlier=median(dev["earlier"]),
                dev=dev, plain_ms=min(pms), plain_dev=p_dev, nbytes=nbytes,
                ops=ops, bound=b_ms, bound_by=b_by,
                tiles=sum(tiles.values()), fill_ms=fill_ms, host=host,
                trace=traces)


INTER_PHASES = ("ZERO", "PRED", "COMB", "SEGUV", "TOP", "LEFT", "RESID")


def inter_trace(pk, clk, nw, cells):
    """The traced inter kernel's stamps (grid, phases, 2: the phase's
    start, the block's part done; zero where a phase does not run) summed
    up per phase that runs: its tiles by slot (the packer's runs; RESID:
    its `cells`), the tiles a warp takes at most (`nw` warps), the blocks'
    work in clock64 cycles (mean and the slowest block), and the wait at
    the barrier after it (the next phase's start less this one's done,
    mean and longest over the blocks)."""
    import numpy as np

    from rav1d_tpu_torch.ops.cuda import inter as IK

    c = clk.cpu().numpy().astype(np.int64)
    ph = IK.phases(pk.inter_runs)
    tiles = [{} for _ in INTER_PHASES]
    for i, slots in enumerate(ph):
        for name, run in slots:
            tiles[i + 1][name] = tiles[i + 1].get(name, 0) + run.n
    for i in (2, 3, 4, 5):  # the zero phase covers COMB..LEFT
        for name, n in tiles[i].items():
            tiles[0][name] = tiles[0].get(name, 0) + n
    ran = [i for i in range(len(INTER_PHASES)) if c[:, i, 0].any()]
    out = {}
    for j, i in enumerate(ran):
        work = c[:, i, 1] - c[:, i, 0]
        n = sum(tiles[i].values())
        row = dict(tiles=tiles[i], per_warp=-(-n // nw),
                   work_mean=round(float(work.mean()), 1),
                   work_max=int(work.max()))
        if j + 1 < len(ran):
            wait = c[:, ran[j + 1], 0] - c[:, i, 1]
            row.update(wait_mean=round(float(wait.mean()), 1),
                       wait_max=int(wait.max()))
        out[INTER_PHASES[i]] = row
    if "RESID" in out:
        out["RESID"].update(tiles={"cells": cells}, per_warp=None)
    return out


def inter_host_split(f, plan, pk, d, ra, reps=50):
    """programs.inter's host side, part by part (perf_counter, ms per call,
    mean of `reps`): the reference-plane lists (engine/run.py dev_plane,
    cached on the pictures), inter_args, the scratch (pools and mask), the
    launch's own call (ops/cuda/inter.py inter_frame without its
    arguments: the barrier word and the C entry, which zeroes it and
    launches), and the whole call of programs.inter."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.run import dev_plane
    from rav1d_tpu_torch.ops.cuda import inter as IK

    (sY, sC), g = inter_inputs(f, plan, pk, d)
    ah, aw = plan.ah, plan.aw
    planes = torch.zeros((3, ah, aw), dtype=torch.int32, device=d.device)
    rows = IK.pool_rows(ah, aw)
    refs = tuple([dev_plane(pic, pl, d.device) for pic, pl in srcs]
                 for srcs in pk.srcs)
    scratch = (torch.empty(rows * 64, dtype=torch.int32, device=d.device),
               torch.empty(rows * 64, dtype=torch.int32, device=d.device),
               torch.empty(ah * aw, dtype=torch.int32, device=d.device))
    args = (planes, ra, d, pk.hdr, pk.inter_runs) + refs + scratch

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return t

    a = IK.inter_args(*args, **g)
    out = dict(
        refs=ms(lambda: tuple([dev_plane(pic, pl, d.device)
                               for pic, pl in srcs] for srcs in pk.srcs)),
        args=ms(lambda: IK.inter_args(*args, **g)),
        scratch=ms(lambda: (
            torch.empty(rows * 64, dtype=torch.int32, device=d.device),
            torch.empty(rows * 64, dtype=torch.int32, device=d.device),
            torch.empty(ah * aw, dtype=torch.int32, device=d.device))),
        launch=ms(lambda: IK._launch("rav1d_inter_batches", IK.NEW, a,
                                     planes)),
        call=ms(lambda: P.inter(planes, ra, d, pk.hdr, pk.inter_runs, *refs,
                                **g)))
    return {k: round(v, 4) for k, v in out.items()}


def profiled_device_ms(fn, reps, name=None):
    """(device time per call of every kernel fn launches, of the kernels
    whose name contains `name`) in a torch.profiler window over `reps`
    calls; None for a time the profiler does not show in any of five
    windows (a window now and then records no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = named = 0.0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                t = getattr(e, "device_time_total", None)
                t = e.cuda_time_total if t is None else t
                us += t
                if name is not None and name in e.key:
                    named += t
        if us and (named or name is None):
            break
    return (us / reps / 1e3 if us else None,
            named / reps / 1e3 if named else None)


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
        dev_ms = profiled_names_ms(  # its mean per launch (one a call)
            lambda: P.resid(d, hdr, tv, ah=ah, aw=aw, bpc=bpc), 10,
            ["itx_frame_kernel"], {"itx_frame_kernel": 1})[1][
                "itx_frame_kernel"]
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
                   slots=(), interintra=False, blobs=None, wave_check=None,
                   time_wave=False, time_inter=False, time_filter=False,
                   on_frame=None, on_decode=None, capture_on_card=False,
                   spy=None):
    """One stream through the port on the card. The host path (captured:
    each frame's plan, and the MD5s; its time includes the capture) must
    give the committed digests `want` where they are given, and its
    planner must send exactly the frames `fallbacks` to the host; the
    inter slots `slots` must carry tiles, and interintra wave items must
    be present if `interintra`. On
    each engine frame's blob the resid program (one itx launch) must equal
    resid_plain (the blobs are appended to the list `blobs` if one is
    given), on each engine inter frame the inter program (one inter kernel
    launch) must equal inter_plain (inter_timing times it per frame if
    `time_inter`), and on the engine frames `wave_check` names (None: all)
    the wave program must equal wave_plain (wave_timing times it per frame
    if `time_wave`; filter_timing times the filter program per frame if
    `time_wave` or `time_filter`). Then one Decoder(device="cuda") must
    decode the stream frame by frame to the host path's MD5s, with those
    fallbacks only, no upload of a host reference plane, one itx launch per
    engine frame, one inter launch per engine inter frame, one wave frame
    launch per engine frame with wave items and no level launch, the
    frames' filter launches (filter_want), each frame's own launches in
    its own decode step, and no call of the plain transforms, of
    inter_plain or of class_step. With `capture_on_card` the capture runs
    on the engine (synth.capture_frames on `dev`, each frame's dense pass
    on its captured plan) in place of the host path, and its MD5s must be
    `want`. `on_frame(key, frame)` is called on each
    engine frame's checked inputs (a dict: f, plan, pk, d, ra, the wave
    input planes and keywords, the filter input fin and keywords fkw, the
    plain wavefront's ms or None); `on_decode(i, ms)` after the decoder's
    frame i; the decode runs inside the context manager `spy` if one is
    given. Returns (itx launches, max |err| of ra, the captured [(f,
    plan)])."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import kernels, run
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine import wave as TW
    from rav1d_tpu_torch.engine.blob import Uploader
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.ops.cuda import wave as WK

    t0 = time.perf_counter()
    host = []
    frames = synth.capture_frames(packets, host,
                                  device=dev if capture_on_card else None)
    host_ms = (time.perf_counter() - t0) * 1e3
    log(f"{label}: {'engine' if capture_on_card else 'host path'} (with "
        f"capture) {len(host)} frames {host_ms:.1f} ms  md5 {host}"
        + ("" if want is None else
           f"  {'==' if host == want else '!='} committed digests"))
    if (want is not None or capture_on_card) and host != want:
        raise AssertionError(f"{label}: the capture's decode differs from "
                             "the committed digests")
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

    # the residual, wave and filter programs on each engine frame's blob
    # against their plain versions (and the allocator brought to the
    # frame's buffer sizes)
    worst = nframes = ninter = 0
    engine_frames = []  # (hdr, layout_i, superres?) of each engine frame
    per_frame = {}  # frame: its launches in the decode, by counter
    for i, (f, plan) in enumerate(frames):
        pk = None if plan is None else pack_frame(f, plan)
        if pk is None:
            continue
        key = f"{label} frame {i}"
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
        planes, kw = wave_input(f, plan, pk, d, ra)
        if pk.srcs is not None:
            ninter += 1
            if time_inter:
                INTER["rows"][key] = inter_timing(key, f, plan, pk, d, ra)
                if key == INTER.get("main"):
                    INTER["main_inputs"] = f, plan, pk, d, ra
        nframes += bool(WK.levels(pk.waves))
        p_ms = None
        if wave_check is None or i in wave_check:
            got = P.wave(planes, ra, d, pk.hdr, pk.waves, **kw)
            got_l = levels_program(planes, ra, d, pk, kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            ref = P.wave_plain(planes, ra, d, pk.hdr, pk.waves, **kw)
            b.record()
            b.synchronize()
            p_ms = a.elapsed_time(b)
            err, err_l = max_err(got, ref), max_err(got_l, ref)
            WAVE["compared"] += 1
            WAVE["err"] = max(WAVE["err"], err)
            WAVE["err_levels"] = max(WAVE["err_levels"], err_l)
            log(f"  frame {i}: wave (frame kernel) == wave_plain, max |err| "
                f"{err}; per-level kernel max |err| {err_l} "
                f"({len(WK.levels(pk.waves))} levels, grid "
                f"{WK.grid(pk.waves)}; wave_plain {p_ms:.1f} ms)")
            if err or err_l:
                raise AssertionError(f"{label} frame {i}: wave (frame kernel "
                                     f"or level kernel, {bpc} bpc) != "
                                     "wave_plain")
        if time_wave:
            WAVE["rows"][key] = wave_timing(key, pk, d, ra, planes, kw, p_ms)
            if key == f"still seed 1 {W}x{H} frame 0":
                WAVE["still1"] = key, (pk, d, ra, planes, kw)
        # the filter program on the wave program's output: the kernels
        # against filter_plain, and timed at 1080p
        fkw = filter_kw(f, plan, pk)
        fin = P.wave(planes, ra, d, pk.hdr, pk.waves, **kw)
        filter_check(f"{label} frame {i}", fin, d, pk.hdr, fkw)
        engine_frames.append((pk.hdr, fkw["layout_i"], pk.need_sr))
        per_frame[i] = dict(filter_want(engine_frames[-1:]), itx=1,
                            wave=int(bool(WK.levels(pk.waves))), level=0,
                            inter=int(pk.srcs is not None))
        if on_frame is not None:
            on_frame(key, dict(f=f, plan=plan, pk=pk, d=d, ra=ra,
                               planes=planes, kw=kw, fin=fin, fkw=fkw,
                               plain_ms=p_ms))
        if time_wave or time_filter:
            FILT["rows"][key] = filter_timing(key, fin, d, pk, fkw)
            FILT["forms"][key] = filter_forms(key, fin, d, pk, fkw)
            if key == f"still seed 1 {W}x{H} frame 0":
                FILT["still1"] = fin, d, pk, fkw
    log(f"  {label}: filter_ == filter_plain (planes and packed output) on "
        f"{len(engine_frames)} engine frames; the inter kernel == inter_plain "
        f"on {ninter} engine inter frames")

    T.engine.stats.update(frames=0, fallback=0, ref_uploads=0)
    I.launches = 0
    kernels.calls = 0
    WK.launches = WK.level_launches = 0
    TW.calls = 0
    IK.launches = IK.earlier_launches = P.inter_plain_calls = 0
    reset_filter_counts()
    # delay 1: the frame ring off, so that stage_ms stays per frame
    dec = T.Decoder(T.Settings(apply_grain=False, max_frame_delay=1),
                    device=dev)
    got, fell = [], []

    def counts():
        return dict(filter_counts(), itx=I.launches, wave=WK.launches,
                    level=WK.level_launches, inter=IK.launches)

    with contextlib.nullcontext() if spy is None else spy:
        for i, data in enumerate(packets):  # a frame a step: stage_ms
            run.reset_stats()
            fb = T.engine.stats["fallback"]
            c0 = counts()
            t0 = time.perf_counter()
            got += synth.decode_md5s(dec, [data])
            ms = (time.perf_counter() - t0) * 1e3
            if T.engine.stats["fallback"] > fb:
                fell.append(i)
            step = {k: v - c0[k] for k, v in counts().items()}
            if step != per_frame.get(i, dict.fromkeys(step, 0)):
                raise AssertionError(f"{label} frame {i}: launches {step}, "
                                     f"not {per_frame.get(i)}")
            if on_decode is not None:
                on_decode(i, ms)
            log(f"  port frame {i}: {ms:.1f} ms wall  md5 {got[-1]}  "
                f"{'==' if got[-1:] == host[i : i + 1] else '!='} host"
                + ("  (host path: the planner's gate)" if i in fell else ""))
            if f"{label} frame {i}" in FILT["rows"]:
                FILT["rows"][f"{label} frame {i}"]["stage_ms"] = \
                    run.stage_ms["filter"]
            if f"{label} frame {i}" in INTER["rows"]:
                INTER["rows"][f"{label} frame {i}"]["stage_ms"] = \
                    run.stage_ms["inter"]
            rest = ms - sum(v for k, v in run.stage_ms.items()
                            if k != "programs")
            log("    stage_ms " + json.dumps(
                {k: round(v, 3) for k, v in run.stage_ms.items()})
                + f"  rest {rest:.1f} ms (wall minus the stages: OBU "
                "parsing, the syntax pass, the planner, Python)")
    launches = I.launches
    plain_calls = kernels.calls
    stats = dict(T.engine.stats)
    w_launches, w_level, w_calls = WK.launches, WK.level_launches, TW.calls
    i_launches, i_plain = IK.launches, P.inter_plain_calls
    i_earlier = IK.earlier_launches
    f_counts = filter_counts()
    WAVE["launches"] += w_launches
    INTER["launches"] += i_launches
    log(f"  {label}: engine stats {stats}  itx launches {launches}  plain "
        f"transform calls {plain_calls}  inter launches {i_launches} for "
        f"{ninter} inter frames (earlier form {i_earlier})  inter_plain "
        f"calls {i_plain}  wave frame "
        f"launches {w_launches} for {nframes} frames with wave items  level "
        f"launches {w_level}  class_step calls {w_calls}")
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
    if w_launches != nframes or w_level or w_calls:
        raise AssertionError(f"{label}: {w_launches} wave frame launches for "
                             f"{nframes} frames, {w_level} level launches, "
                             f"{w_calls} class_step calls")
    if i_launches != ninter or i_plain or i_earlier:
        raise AssertionError(f"{label}: {i_launches} inter launches for "
                             f"{ninter} engine inter frames, {i_plain} "
                             f"inter_plain calls, {i_earlier} launches of "
                             "the earlier inter form")
    check_filter_counts(label, f_counts, filter_want(engine_frames))
    return launches, worst, frames


def wave_input(f, plan, pk, d, ra):
    """(planes, keywords) of the wave program on a frame's blob: zero
    planes, or on an inter frame the inter program's output through the
    inter kernel (on the stacked reference planes), which must equal
    inter_plain's on the same input."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.headers import PixelLayout as PL

    ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
    sh = 0 if f.cur.layout == PL.I444 else 1
    sv = 1 if f.cur.layout == PL.I420 else 0
    planes = torch.zeros((3, ah, aw), dtype=torch.int32, device=d.device)
    if pk.srcs is not None:
        stacks, g = inter_inputs(f, plan, pk, d)
        args = (ra, d, pk.hdr, pk.inter_runs) + stacks
        want = P.inter_plain(planes, *args, **g)
        planes = P.inter(planes, *args, **g)
        err = max_err(planes, want)
        INTER["compared"] += 1
        INTER["err"] = max(INTER["err"], err)
        if err:
            raise AssertionError(f"inter kernel ({bpc} bpc) != inter_plain, "
                                 f"max |err| {err}")
    return planes, dict(ah=ah, aw=aw, bpc=bpc, ss_hor=sh, ss_ver=sv)


# least 32-bit operations per predicted pixel by mode code, and per value
# of a directional mode's edge vector (an estimate from the formulas of
# ops/ipred_dyn.py: adds, subtracts, multiplies, shifts, compares; a clip
# two): Paeth 10, smooth 11, smooth_v/h 6, Z1/Z3 10 (+11 per edge value),
# Z2 14 (+11), filter intra 17, CfL 10 (+ the subsampling adds)
_PX_OPS = {12: 10, 9: 11, 10: 6, 11: 6, 6: 10, 8: 10, 7: 14, 13: 17,
           15: 10, 16: 10, 17: 10, 18: 10}


def wave_work(pk, ss_hor, ss_ver):
    """(bytes, operations) of the frame's wavefront, each input read once
    and each output written once, at int32 words: per item its 21-word
    descriptor, its edge pixels (phl + phbl left, pht + phtr top, the
    corner), its residuals (rmask), its own pixels (IDENT, interintra),
    its mask (interintra) and its CfL luma, and its pixels written; the
    operations of _PX_OPS, the DC sums, the residual add and clip (3 per
    pixel) and the interintra blend (6 per pixel)."""
    import numpy as np

    from rav1d_tpu_torch.engine.layout import FI, N_FIELDS

    nbytes = nops = 0
    sub = (1 + ss_hor) * (1 + ss_ver)
    lut = np.zeros(32, np.int64)
    lut[list(_PX_OPS)] = list(_PX_OPS.values())
    for per in pk.waves:
        for rows, n, _, _ in per:
            r = rows[:n].astype(np.int64)
            mode = r[:, FI["modes"]]
            w, h = r[:, FI["w"]], r[:, FI["h"]]
            px = w * h
            hav = r[:, FI["hav"]]
            edge = (np.where(hav & 1, r[:, FI["phl"]] + r[:, FI["phbl"]], 0)
                    + np.where(hav & 2, r[:, FI["pht"]] + r[:, FI["phtr"]], 0)
                    + (hav != 0))
            ii = r[:, FI["iioff"]] >= 0
            res = r[:, FI["rmask"]] != 0
            cfl = mode >= 15
            own = (mode == 14) | ii
            words = (N_FIELDS + edge + px * (res + own + ii + cfl * sub + 1))
            nbytes += 4 * int(words.sum())
            per_px = np.where((mode >= 0) & (mode < 32),
                              lut[np.clip(mode, 0, 31)], 0)
            vec = np.where((mode == 6) | (mode == 8), 2 * (w + h),
                           np.where(mode == 7, w + h + 1, 0))
            dcs = np.where((mode <= 5) | (mode >= 15), w + h + 6, 0)
            nops += int((px * (per_px + 3 * res + 6 * ii + cfl * (sub - 1))
                         + 11 * vec + dcs).sum())
    return nbytes, nops


def wave_timing(label, pk, d, ra, planes, kw, plain_ms):
    """The wave program alone on a frame's blob, through the frame kernel
    (programs.wave) and through the level kernel (levels_program): CUDA
    events per call (host calls included), the device time of all its
    kernels and of the wave kernel's launches (torch.profiler), and per
    level; the frame kernel's barrier-only floor (the same grid, level walk
    and barriers, no item work; CUDA events and its device time) beside
    the empty-launch floor of the level kernel's calls (CUDA events); and
    the bound. Returns a dict of them."""
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import wave as WK

    def frame():
        P.wave(planes, ra, d, pk.hdr, pk.waves, **kw)

    def per_level():
        levels_program(planes, ra, d, pk, kw)

    pf = P.palette_pf(planes, d, pk.hdr)
    wk = wave_kw(kw)

    def barriers():
        WK.barrier_frame(pf, ra, d, pk.hdr, pk.waves, **wk)

    def empty():
        WK.empty_levels(pf, ra, d, pk.hdr, pk.waves, **wk)

    # in turns: frame, level, level, frame
    ms = [cuda_ms(frame, 3)]
    ms_l = [cuda_ms(per_level, 3)]
    ms_l.append(cuda_ms(per_level, 3))
    ms.append(cuda_ms(frame, 3))
    # the frame kernel's mean per launch (one a call)
    dev_ms, k_ms = profiled_names_ms(frame, 3, ["wave_frame_kernel"],
                                     {"wave_frame_kernel": 1})
    k_ms = k_ms["wave_frame_kernel"]
    dev_l, k_l = profiled_device_ms(per_level, 1, "wave_level_kernel")
    bar_ms = cuda_ms(barriers, 3)
    bar_dev = profiled_device_ms(barriers, 1, "wave_barrier_kernel")[1]
    floor = cuda_ms(empty, 3)
    trace = wave_trace(pk, WK.trace_frame(pf.clone(), ra, d, pk.hdr, pk.waves,
                                          **wk))
    nbytes, ops = wave_work(pk, kw["ss_hor"], kw["ss_ver"])
    b_ms, b_by = bound(nbytes, ops)
    nl = len(WK.levels(pk.waves))
    items = sum(n for per in pk.waves for _, n, _, _ in per)
    row = dict(levels=nl, items=items, grid=WK.grid(pk.waves),
               ms=min(ms), ms_levels=min(ms_l), dev_ms=dev_ms, k_ms=k_ms,
               dev_levels=dev_l, k_levels=k_l, barrier_ms=bar_ms,
               barrier_dev=bar_dev, floor=floor, plain_ms=plain_ms,
               nbytes=nbytes, ops=ops, bound=b_ms, trace=trace)

    def txt(v, f="%.3f ms"):
        return "not measured" if v is None else f % v

    def per(v):
        return "not measured" if v is None else "%.3f us" % (v * 1e3 / nl)

    log(f"  wave {label}: {nl} levels, {items} items, frame grid "
        f"{row['grid']} blocks; programs.wave (frame kernel) "
        f"{ms[0]:.3f}/{ms[1]:.3f} ms (CUDA events), device {txt(dev_ms)} "
        f"(all kernels) of which wave_frame_kernel {txt(k_ms)} "
        f"({per(k_ms)} per level; torch.profiler); per-level program "
        f"{ms_l[0]:.3f}/{ms_l[1]:.3f} ms, device {txt(dev_l)} of which "
        f"wave_level_kernel {txt(k_l)} ({per(k_l)} per level); barrier-only "
        f"floor {bar_ms:.3f} ms (CUDA events), device {txt(bar_dev)} "
        f"({per(bar_dev)} per level); empty-launch floor {floor:.3f} ms "
        f"({per(floor)} per level); bound {b_ms:.5f} ms ({b_by}: {nbytes} "
        f"bytes, {ops} ops); wave_plain {txt(plain_ms, '%.1f ms')}")
    log(f"  wave {label} trace (clock64 cycles per level, mean over "
        f"levels): {json.dumps(trace)}")
    return row


def wave_trace(pk, clk):
    """The traced frame kernel's stamps (levels, grid, 6: start, edge
    built, prediction done, stores done, read-ahead done, arrival made)
    summed up: per level, the period on the slowest block's SM (its start
    to its next start), that block's item work split into the edge step,
    the middle and prediction steps and the store step, what follows its
    stores (the read-ahead, the arrival's fence and add, the wait); the
    mean work of all blocks with items; the
    slowest block's class, and its work by mode code (the share of the
    summed slowest-block work, the five largest)."""
    import numpy as np

    from rav1d_tpu_torch.engine.layout import FI
    from rav1d_tpu_torch.ops.cuda import wave as WK

    c = clk.cpu().numpy().astype(np.int64)
    start, edge, pred, store, ahead, arrive = (c[..., k] for k in range(6))
    lv = WK.levels(pk.waves)
    nl = len(lv)
    L = np.arange(nl)
    work = store - start
    has = np.arange(c.shape[1])[None, :] < np.array(
        [ns + nl_ for _, ns, nl_ in lv])[:, None]
    crit = np.where(has, work, -1).argmax(axis=1)
    period = start[1:, :] - start[:-1, :]
    after = start[1:, :] - store[:-1, :]
    modes, large = {}, 0
    for m, (i, ns, _) in enumerate(lv):
        b = int(crit[m])
        rows = pk.waves[i][0 if b < ns else 1][0]
        mode = int(rows[b if b < ns else b - ns, FI["modes"]])
        large += b >= ns
        modes[mode] = modes.get(mode, 0) + int(work[m, b])
    total = sum(modes.values()) or 1
    top = sorted(modes.items(), key=lambda kv: -kv[1])[:5]

    def mean(a):
        return round(float(a.mean()), 1) if a.size else None

    return dict(
        period=mean(period[L[:-1], crit[:-1]]),
        crit_work=mean(work[L, crit]),
        crit_edge=mean((edge - start)[L, crit]),
        crit_mid_pred=mean((pred - edge)[L, crit]),
        crit_store=mean((store - pred)[L, crit]),
        crit_after=mean(after[L[:-1], crit[:-1]]),
        crit_ahead=mean((ahead - store)[L, crit]),
        crit_arrive=mean((arrive - store)[L, crit]),
        mean_work=mean(work[has]),
        crit_large=round(large / max(nl, 1), 3),
        crit_modes={str(k): round(v / total, 3) for k, v in top})


# ------------------------------ post filters ------------------------------

# the filter kernels: (counter key, kernel names in the profiler, entry,
# source, the TPU kernel it replaces); the deblock entry's two kernels are
# its two directions
FILTERS = (
    ("lf", ("lf_rows_kernel", "lf_cols_kernel"), "rav1d_deblock", "lf.cu",
     "rav1d_tpu/engine/filters.py:34"),
    ("cdef", ("cdef_area_kernel",), "rav1d_cdef", "cdef.cu",
     "rav1d_tpu/engine/filters.py:84"),
    ("sr", ("superres_kernel",), "rav1d_superres_frame", "superres.cu",
     "rav1d_tpu/engine/filters.py:185"),
    ("wiener", ("lr_wiener_frame_kernel",), "rav1d_lr_wiener_frame",
     "lr.cu", "rav1d_tpu/engine/filters.py:246"),
    ("sgr", ("lr_sgr_frame_kernel",), "rav1d_lr_sgr_frame", "lr.cu",
     "rav1d_tpu/engine/filters.py:253"),
)
# the earlier forms of deblock, CDEF and the two loop restoration filters
# (on no decoder path), likewise
EARLIER = (
    ("lf_lines", ("lf_pass_kernel",), "rav1d_lf_pass", "lf.cu",
     "rav1d_tpu/engine/filters.py:34"),
    ("cdef_global", ("cdef_frame_kernel",), "rav1d_cdef_frame", "cdef.cu",
     "rav1d_tpu/engine/filters.py:84"),
    ("wiener_plane", ("lr_wiener_kernel",), "rav1d_lr_wiener", "lr.cu",
     "rav1d_tpu/engine/filters.py:246"),
    ("sgr_plane", ("lr_sgr_kernel",), "rav1d_lr_sgr", "lr.cu",
     "rav1d_tpu/engine/filters.py:253"),
)
# each earlier form: the filter_forms stages it runs, the new kernel's key
EARLIER_STAGES = {"lf_lines": (("lf_v", "lf_h"), "lf"),
                  "cdef_global": (("cdef",), "cdef"),
                  "wiener_plane": (("wiener",), "wiener"),
                  "sgr_plane": (("sgr",), "sgr")}
# the filter kernels across the run: launches in the decodes (the earlier
# forms' must stay 0) and in the earlier forms' own run ("own"), frames
# whose filter_ was held to filter_plain, the largest difference per
# kernel in the kernel phase and the forms' comparisons, per-frame
# timings by label (the 1080p superres still's label under "sr_main"),
# the forms' per-frame comparisons by label
FILT = {"launches": {k[0]: 0 for k in FILTERS + EARLIER}, "own": {},
        "compared": 0, "err": {k[0]: 0 for k in FILTERS + EARLIER},
        "rows": {}, "forms": {}, "seconds": 0.0}


def _filter_seconds(fn):
    """fn, its wall time added to FILT["seconds"]: what the filter checks
    and timings add to the run."""
    @functools.wraps(fn)
    def call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            FILT["seconds"] += time.perf_counter() - t0
    return call


def filter_kw(f, plan, pk):
    """programs.filter_'s keywords for a frame, as engine/run.py execute
    makes them."""
    out = f.sr_cur
    ach, acw = out.u.shape if out.u is not None else (0, 0)
    sr = (out.y.shape + (out.w, out.h, 4 * f.bw)) if pk.need_sr else None
    return dict(geom=(plan.ah, plan.aw, ach, acw, f.bh, f.bw, f.cur.h),
                bpc=f.cur.bpc, layout_i=int(f.cur.layout), lr_ws=pk.lr_ws,
                sr_geom=sr)


def filter_counts():
    """The filter kernels' launch counters and the plain passes' calls."""
    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.ops.cuda import filters as FK

    return dict(lf=FK.lf_launches, cdef=FK.cdef_launches,
                sr=FK.sr_launches, wiener=FK.wiener_launches,
                sgr=FK.sgr_launches, lf_lines=FK.lf_lines_launches,
                cdef_global=FK.cdef_global_launches,
                wiener_plane=FK.wiener_plane_launches,
                sgr_plane=FK.sgr_plane_launches, filter_plain=FL.calls)


def reset_filter_counts():
    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.ops.cuda import filters as FK

    FK.lf_launches = FK.cdef_launches = FK.sr_launches = 0
    FK.wiener_launches = FK.sgr_launches = 0
    FK.lf_lines_launches = FK.cdef_global_launches = 0
    FK.wiener_plane_launches = FK.sgr_plane_launches = 0
    FL.calls = 0


def filter_want(frames):
    """The filter launches of engine frames [(hdr, layout_i, superres?)]:
    two deblock and one CDEF launch each, one superres launch each with
    superres, one Wiener launch each with such stripes in any plane, one
    self-guided launch each with such stripes in any plane; no launch of
    the earlier deblock, CDEF, Wiener and self-guided forms and no plain
    filter call (engine/filters.py calls counts the plain upscale too)."""
    from rav1d_tpu_torch.ops.cuda import filters as FK

    want = dict(lf=0, cdef=0, sr=0, wiener=0, sgr=0, lf_lines=0,
                cdef_global=0, wiener_plane=0, sgr_plane=0, filter_plain=0)
    for hdr, layout_i, sr in frames:
        w, s = FK.lr_launches(hdr, layout_i)
        want["lf"] += 2
        want["cdef"] += 1
        want["sr"] += int(sr)
        want["wiener"] += w
        want["sgr"] += s
    return want


def check_filter_counts(label, got, want):
    """Launch counts of a decode: they must be `want`; counted into FILT."""
    log(f"  {label}: filter launches {json.dumps(got)}, want "
        f"{json.dumps(want)}")
    if got != want:
        raise AssertionError(f"{label}: filter launches {got}, not {want}")
    for k in FILT["launches"]:
        FILT["launches"][k] += got[k]


@_filter_seconds
def filter_check(label, fin, d, hdr, kw):
    """filter_ (the kernels) against filter_plain on a frame's filter input
    `fin`: planes and packed output equal. Returns filter_'s output."""
    import torch

    from rav1d_tpu_torch.engine import programs as P

    got, packed = P.filter_(fin.clone(), d, hdr, **kw)
    want, packed_w = P.filter_plain(fin.clone(), d, hdr, **kw)
    if not (torch.equal(got, want) and torch.equal(packed, packed_w)):
        err = max_err(got, want) if got.shape == want.shape else -1
        raise AssertionError(f"{label}: filter_ (the filter kernels) != "
                             f"filter_plain (max |err| {err})")
    FILT["compared"] += 1
    return got


class FilterRecorder:
    """While installed, each programs.filter_ call (engine/run.py calls it
    through the module, on the frame ring's worker too) is recorded: a copy
    of its input planes (filter_ writes them), its blob (a fresh tensor per
    frame), header and keywords, and its outputs. `check` then holds each
    to filter_plain, after the decode: the recording itself reads nothing
    back, so it runs under set_sync_debug_mode("error")."""

    def __enter__(self):
        from rav1d_tpu_torch.engine import programs as P

        self.P, self.real, self.calls = P, P.filter_, []

        def filter_(planes, dev, hdr, **kw):
            rec = (planes.clone(), dev, hdr.copy(), kw)
            out = self.real(planes, dev, hdr, **kw)
            self.calls.append(rec + tuple(out))
            return out

        P.filter_ = filter_
        return self

    def __exit__(self, *exc):
        self.P.filter_ = self.real

    @_filter_seconds
    def check(self, label):
        """filter_plain on every recorded input against what filter_ gave;
        returns the frames' (hdr, layout_i, superres?) for filter_want."""
        import torch

        for i, (fin, d, hdr, kw, got, packed) in enumerate(self.calls):
            want, packed_w = self.P.filter_plain(fin, d, hdr, **kw)
            if not (torch.equal(got, want) and torch.equal(packed, packed_w)):
                raise AssertionError(f"{label}: filter call {i}: filter_ != "
                                     "filter_plain")
            FILT["compared"] += 1
        frames = [(c[2], c[3]["layout_i"], c[3]["sr_geom"] is not None)
                  for c in self.calls]
        self.calls = []
        return frames


class InterRecorder:
    """While installed, each programs.inter call (engine/run.py calls it
    through the module, on the frame ring's worker too) is recorded: a copy
    of its input planes (the kernel writes them in place), its residuals
    and blob (fresh tensors per frame), header, runs, reference planes and
    keywords, and a copy of its output. `check` then holds each to
    inter_plain, after the decode: the recording itself reads nothing
    back, so it runs under set_sync_debug_mode("error")."""

    def __enter__(self):
        from rav1d_tpu_torch.engine import programs as P

        self.P, self.real, self.calls = P, P.inter, []

        def inter(planes, ra, dev, hdr, runs, refsY, refsC, **kw):
            fin = planes.clone()
            out = self.real(planes, ra, dev, hdr, runs, refsY, refsC, **kw)
            self.calls.append((fin, ra, dev, hdr.copy(), runs, refsY, refsC,
                               kw, out.clone()))
            return out

        P.inter = inter
        return self

    def __exit__(self, *exc):
        self.P.inter = self.real

    def check(self, label):
        """inter_plain on every recorded input against what programs.inter
        gave; returns how many there were."""
        import torch

        def stack(refs, like):
            return (torch.stack(list(refs)) if len(refs) else
                    torch.zeros((1, 1, 1), dtype=torch.uint8,
                                device=like.device))

        for i, (fin, ra, d, hdr, runs, rY, rC, kw, got) in enumerate(
                self.calls):
            want = self.P.inter_plain(fin, ra, d, hdr, runs, stack(rY, fin),
                                      stack(rC, fin), **kw)
            err = max_err(got, want)
            INTER["compared"] += 1
            INTER["err"] = max(INTER["err"], err)
            if err:
                raise AssertionError(f"{label}: inter call {i}: the inter "
                                     f"kernel != inter_plain (max |err| "
                                     f"{err})")
        n = len(self.calls)
        self.calls = []
        return n


# least 32-bit operations per filtered line of a deblock edge by filter
# width, and the pixels it reads and writes (an estimate from the formulas
# of ops/lf.py: the masks' differences, absolutes and compares, the
# filter's sums, shifts and clamps)
_LF_OPS = {4: 45, 6: 100, 8: 135, 16: 360}
_LF_READ = {4: 4, 6: 6, 8: 8, 16: 14}
_LF_WRITE = {4: 4, 6: 4, 8: 6, 16: 12}
# CDEF: per unit's direction search; per filtered pixel with both
# strengths, the primary only, the secondary only (ops/cdef.py: 12, 4 or
# 8 taps, each a difference, absolute, shift, subtract, max, min, sign and
# multiply-add; the running minimum and maximum; the round)
_CDEF_DIR_OPS = 700
_CDEF_PX_OPS = {3: 140, 1: 50, 2: 100}
# LR per restored pixel: Wiener (7 + 7 taps, rounds and clips), one
# self-guided filter (box sums, the A/B tables, the weighted sums), both
_LR_OPS = {"w": 35, 0: 60, 1: 60, 2: 120}
# superres per output pixel: 8 multiplies and 7 adds, the negation, round,
# shift and two clamps
_SR_OPS = 20


def sr_planes(kw):
    """[(h, dst_w, src_w)] of the superres upscale's planes with pixels, as
    programs._superres derives them from filter_'s keywords."""
    from rav1d_tpu_torch.ops.cuda import filters as FK

    _, _, sr_w, _, srcw_y = kw["sr_geom"]
    cur_h = kw["geom"][6]
    ss_hor, ss_ver = FK.subsampling(kw["layout_i"])
    out = []
    for pl in range(3 if kw["layout_i"] else 1):
        sh, sv = (ss_hor, ss_ver) if pl else (0, 0)
        out.append(((cur_h + sv) >> sv, (sr_w + sh) >> sh,
                    (srcw_y + sh) >> sh))
    return out


def filter_work(pk, kw):
    """{kernel: (bytes, operations)} of a frame's filters, each input read
    once and each output written once, at int32 pixels, from the frame's
    maps and stripes: deblock ("lf", and each direction alone, "lf_v" and
    "lf_h"), the selected edges' lines (the pixels each filter width reads
    and writes) and the maps; CDEF, the luma of each
    unit that needs a direction, each filtered unit's pixels read and
    written, the maps; superres, each plane's source rows read and the
    whole (2, 3, s_ah, s_aw) output written, the taps of each visible
    output pixel of both inputs; LR, each stripe's tile (its rows and
    columns with the 3-pixel margins) read and its pixels written, its
    descriptor."""
    import numpy as np

    from rav1d_tpu_torch.engine.layout import CDEF0, DB0
    from rav1d_tpu_torch.ops.cuda import filters as FK

    words = pk.words()
    hdr = pk.hdr

    def u8(base, n):
        return words[base : base + (n + 3) // 4].view(np.uint8)[:n].astype(
            np.int64)

    _, _, _, _, bh, bw, _ = kw["geom"]
    lay = kw["layout_i"]
    ss_hor, ss_ver = FK.subsampling(lay)
    ch4, cw4 = (bh + ss_ver) >> ss_ver, (bw + ss_hor) >> ss_hor
    planes = [(bh, bw)] + ([(ch4, cw4)] * 2 if lay else [])
    work = {}
    for hor in (0, 1):  # lf_v, lf_h: each direction reads the luts
        nb = ops = 512
        for p, (nh, nw) in enumerate(planes):
            b = u8(int(hdr[DB0 + 1 + 3 * hor + p]), nh * nw)
            cls, lvl = b >> 6, b & 63
            nb += nh * nw
            for c in (1, 2, 3):
                n = int(((cls == c) & (lvl != 0)).sum())
                wd = (4 << (c - 1)) if p == 0 else 4 + 2 * (c - 1)
                nb += 4 * n * 4 * (_LF_READ[wd] + _LF_WRITE[wd])
                ops += 4 * n * _LF_OPS[wd]
        work["lf_h" if hor else "lf_v"] = (nb, ops)
    work["lf"] = (work["lf_v"][0] + work["lf_h"][0] - 512,
                  work["lf_v"][1] + work["lf_h"][1] - 512)
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    yl = u8(int(hdr[CDEF0]), nby * nbx)
    ul = u8(int(hdr[CDEF0 + 1]), nby * nbx)
    ycode = ((yl >> 2) > 0) + 2 * ((yl & 3) > 0)
    ucode = ((ul >> 2) > 0) + 2 * ((ul & 3) > 0) if lay else ul * 0
    need_dir = ((yl >> 2) > 0) | ((ul >> 2) > 0) if lay else (yl >> 2) > 0
    cpx = (8 >> ss_ver) * (8 >> ss_hor)
    nb = 2 * nby * nbx + 4 * 64 * int((need_dir & (ycode == 0)).sum())
    ops = _CDEF_DIR_OPS * int(need_dir.sum())
    for code, per in _CDEF_PX_OPS.items():
        ny, nu = int((ycode == code).sum()), int((ucode == code).sum())
        nb += 4 * 2 * (64 * ny + 2 * cpx * nu)
        ops += per * (64 * ny + 2 * cpx * nu)
    work["cdef"] = (nb, ops)
    if kw["sr_geom"] is not None:
        s_ah, s_aw = kw["sr_geom"][:2]
        geo = sr_planes(kw)
        work["sr"] = (2 * 4 * sum(h * sw for h, _, sw in geo)
                      + 2 * 3 * 4 * s_ah * s_aw,
                      2 * _SR_OPS * sum(h * dw for h, dw, _ in geo))
    for key, kinds in (("wiener", ("w",)), ("sgr", (0, 1, 2))):
        nb = ops = 0
        for p, _ in enumerate(planes):
            W = kw["lr_ws"][1 if p else 0]
            for kind in kinds:
                base, n = FK.lr_chunks(hdr, p)[kind]
                if not n:
                    continue
                d = words[base : base + n * 16 * 64].reshape(n, 16, 64)
                d = d.transpose(1, 0, 2).reshape(16, -1).astype(np.int64)
                h = np.clip(d[3], 0, 64)
                w = np.clip(d[2], 0, W)
                on = (h > 0) & (w > 0)
                nb += int((4 * ((h + 6) * (w + 6) + h * w) + 64)[on].sum())
                ops += _LR_OPS[kind] * int((h * w)[on].sum())
        work[key] = (nb, ops)
    return work


def profiled_names_ms(fn, reps, names, per_call=None):
    """(device time per call of every kernel fn launches, {name: device
    time per call of the kernels whose name contains it}) in a
    torch.profiler window over `reps` calls; None for a time the profiler
    does not show in any of five windows. With `per_call` ({name: launches
    per call}), a name's time is its launches' mean times that count (the
    same where the window kept every launch; a window that drops some
    launches' records does not shrink it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):  # a window now and then records no device time
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, per = 0.0, dict.fromkeys(names, 0.0)
        count = dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                t = getattr(e, "device_time_total", None)
                t = e.cuda_time_total if t is None else t
                us += t
                for n in names:
                    if n in e.key:
                        per[n] += t
                        count[n] += e.count
        if us and all(per.values()):
            break
    return (us / reps / 1e3 if us else None,
            {n: (None if not v else v / reps / 1e3 if per_call is None
                 else v / count[n] * per_call[n] / 1e3)
             for n, v in per.items()})


def plain_pieces_ms(fn):
    """fn (a filter_plain call) once with CUDA events around each call of
    the plain passes (programs._superres for the upscale: its six
    resize_plane calls, pads and stacks): {kernel key: ms}, the deblock
    passes also by direction ("lf_v", "lf_h") (host dispatch included: the
    plain passes are launch-bound)."""
    import torch

    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.engine import programs as P

    marks = {k[0]: [] for k in FILTERS}
    marks.update(lf_v=[], lf_h=[])
    names = {(FL, "lf_dir_pass"): "lf", (FL, "cdef_pass"): "cdef",
             (P, "_superres"): "sr", (FL, "lr_wiener_pass"): "wiener",
             (FL, "lr_sgr_pass"): "sgr"}
    real = {n: getattr(*n) for n in names}

    def timed(n):
        def call(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real[n](*a)
            e1.record()
            marks[names[n]].append((e0, e1))
            if names[n] == "lf":  # lf_dir_pass(plane, ..., luma, hor, bpc)
                marks["lf_h" if a[5] else "lf_v"].append((e0, e1))
            return out
        return call

    for n in names:
        setattr(*n, timed(n))
    try:
        fn()
    finally:
        for n, f in real.items():
            setattr(*n, f)
    torch.cuda.synchronize()
    return {k: (sum(a.elapsed_time(b) for a, b in v) if v else None)
            for k, v in marks.items()}


def kernel_event_ms(fin, d, pk, kw):
    """{kernel: ms} of each filter kernel's launches for one frame, through
    its wrapper alone on the frame's filter input (CUDA events over 10
    frames' launches, host calls included; the launches are counted but
    happen outside the decodes, whose counts are reset before them); the
    earlier loop restoration forms' per-plane launches too ("wiener_plane",
    "sgr_plane")."""
    from rav1d_tpu_torch.ops.cuda import filters as FK

    _, _, _, _, bh, bw, vis_h = kw["geom"]
    k = dict(bh=bh, bw=bw, layout_i=kw["layout_i"], bpc=kw["bpc"])
    ss_ver = FK.subsampling(kw["layout_i"])[1]
    x, pre, out = fin.clone(), fin.clone(), fin.clone()

    def lf():
        FK.lf_pass(x, d, pk.hdr, False, **k)
        FK.lf_pass(x, d, pk.hdr, True, **k)

    def lr(launch, kinds):
        def run():
            for p in range(3 if kw["layout_i"] else 1):
                if any(FK.lr_chunks(pk.hdr, p)[i][1] for i in kinds):
                    sv = ss_ver if p else 0
                    launch(out[p], x[p], pre[p], d, pk.hdr, p,
                           ph=(vis_h + sv) >> sv,
                           W=kw["lr_ws"][1 if p else 0], bpc=kw["bpc"])
        return run

    phs = tuple((vis_h + sv) >> sv for sv in (0, ss_ver, ss_ver))
    Ws = (kw["lr_ws"][0],) + (kw["lr_ws"][1],) * 2
    ms = {"lf": cuda_ms(lf, 10),
          "cdef": cuda_ms(lambda: FK.cdef_frame(out, pre, d, pk.hdr, **k),
                          10),
          "wiener": cuda_ms(lambda: FK.lr_wiener_frame(
              out, x, pre, d, pk.hdr, layout_i=kw["layout_i"], phs=phs,
              Ws=Ws, bpc=kw["bpc"]), 10),
          "sgr": cuda_ms(lambda: FK.lr_sgr_frame(
              out, x, pre, d, pk.hdr, layout_i=kw["layout_i"], phs=phs,
              Ws=Ws, bpc=kw["bpc"]), 10),
          "wiener_plane": cuda_ms(lr(FK.lr_wiener_plane, ("w",)), 10),
          "sgr_plane": cuda_ms(lr(FK.lr_sgr_plane, (0, 1, 2)), 10)}
    if kw["sr_geom"] is not None:
        ms["sr"] = cuda_ms(lambda: FK.superres_frame(
            x, pre, pk.hdr, cur_h=vis_h, sr_geom=kw["sr_geom"],
            layout_i=kw["layout_i"], bpc=kw["bpc"]), 10)
    return ms


def superres_library(fin, pk, kw):
    """The upscale of a frame's planes and snapshot (here both `fin`)
    through one torch.matmul per plane: the (2, h, src_w) float32 source
    rows by the plane's banded (src_w, dst_w) resampling matrix, built on
    the host from the same taps and clamps, in float32 with TF32 off
    (exact: every partial sum is an integer below 4095 * 216 < 2^24), then
    one rounding and clip pass. Returns (ms per call, CUDA events, the
    visible outputs [(2, h, dst_w) int32 per plane])."""
    import numpy as np
    import torch

    from rav1d_tpu_torch.engine.consts import numpy_tables
    from rav1d_tpu_torch.engine.layout import SR0

    rf = numpy_tables()["resize_filter"]
    pxmax = (1 << kw["bpc"]) - 1
    mats = []
    for pl, (h, dst_w, src_w) in enumerate(sr_planes(kw)):
        ci = 1 if pl else 0
        dx, mx0 = int(pk.hdr[SR0 + 2 * ci]), int(pk.hdr[SR0 + 2 * ci + 1])
        pos = mx0 + np.arange(dst_w, dtype=np.int64) * dx
        sx = -1 + (pos >> 14) - (mx0 >> 14)
        m = np.zeros((src_w, dst_w), np.float32)
        for k in range(8):
            np.add.at(m, (np.clip(sx + k - 3, 0, src_w - 1), np.arange(dst_w)),
                      rf[(pos & 0x3FFF) >> 8, k])
        mats.append((pl, h, src_w, torch.from_numpy(m).to(fin.device)))
    src = torch.stack([fin, fin])  # (2, 3, ah, aw): the planes, the snapshot

    def call():
        outs = []
        for pl, h, src_w, m in mats:
            acc = torch.matmul(src[:, pl, :h, :src_w].float(), m)
            outs.append(torch.clamp(torch.floor((64 - acc) * (1 / 128)), 0,
                                    pxmax).to(torch.int32))
        return outs

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = call()
        ms = cuda_ms(call, 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return ms, outs


@_filter_seconds
def filter_timing(label, fin, d, pk, kw):
    """The filter program alone on a frame's filter input: filter_ (the
    kernels) and filter_plain in turns (CUDA events, host calls included),
    the device time of all filter_'s kernels and of each filter kernel
    (torch.profiler), each plain pass's time (CUDA events), and each
    kernel's bound (filter_work); on a superres frame the library's
    upscale (superres_library), which must equal programs._superres.
    Returns a dict of them."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import filters as FK

    x, y = fin.clone(), fin.clone()  # filter_ writes its input in place

    def kern():
        P.filter_(x, d, pk.hdr, **kw)

    def plain():
        P.filter_plain(y, d, pk.hdr, **kw)

    ms = [cuda_ms(kern, 10)]
    pms = [cuda_ms(plain, 1)]
    pms.append(cuda_ms(plain, 1))
    ms.append(cuda_ms(kern, 10))
    sr = kw["sr_geom"] is not None
    keys = [k for k in FILTERS if sr or k[0] != "sr"]
    w, s = FK.lr_launches(pk.hdr, kw["layout_i"])
    nl = dict(lf=2, cdef=1, sr=1, wiener=w, sgr=s)
    dev_ms, per = profiled_names_ms(
        kern, 5, [n for k in keys for n in k[1]],
        {n: nl[k[0]] // len(k[1]) for k in keys for n in k[1]})
    ev = kernel_event_ms(fin, d, pk, kw)
    pieces = plain_pieces_ms(plain)
    work = filter_work(pk, kw)
    row = dict(ms=min(ms), ms_all=ms, plain_ms=min(pms), plain_all=pms,
               dev_ms=dev_ms, kernels={})
    for key, names, *_ in keys:
        b_ms, b_by = bound(*work[key])
        ms_k = [per[n] for n in names]
        row["kernels"][key] = dict(dev_ms=None if None in ms_k else sum(ms_k),
                                   ev_ms=ev[key],
                                   launches=nl[key],
                                   plain_ms=pieces[key], nbytes=work[key][0],
                                   ops=work[key][1], bound=b_ms, bound_by=b_by)
    if sr:  # the library's upscale, held to the plain one
        lib_ms, outs = superres_library(fin, pk, kw)
        want = P._superres(fin, fin, pk.hdr, kw["geom"][6], kw["sr_geom"],
                           *FK.subsampling(kw["layout_i"]),
                           kw["layout_i"] != 0, kw["bpc"])
        for pl, o in enumerate(outs):
            h, dst_w = o.shape[1:]
            plain_o = torch.stack([want[0][pl, :h, :dst_w],
                                   want[1][pl, :h, :dst_w]])
            if not torch.equal(o, plain_o):
                raise AssertionError(f"{label}: the library's upscale of "
                                     f"plane {pl} != programs._superres")
        row["kernels"]["sr"]["library_ms"] = lib_ms

    def txt(v, f="%.4f ms"):
        return "not measured" if v is None else f % v

    log(f"  filter {label}: filter_ (kernels) {ms[0]:.3f}/{ms[1]:.3f} ms, "
        f"filter_plain {pms[0]:.1f}/{pms[1]:.1f} ms (CUDA events, in turns); "
        f"device {txt(dev_ms)} (all of filter_'s kernels, torch.profiler)")
    for key, k in row["kernels"].items():
        log(f"    {key}: {k['launches']} launches, device {txt(k['dev_ms'])}"
            f" (torch.profiler), its launches alone {k['ev_ms']:.4f} ms "
            "(CUDA events), "
            f"bound {k['bound']:.5f} ms ({k['bound_by']}: {k['nbytes']} bytes, "
            f"{k['ops']} ops), plain passes {txt(k['plain_ms'], '%.2f ms')}"
            + (f", library (torch.matmul) {k['library_ms']:.4f} ms"
               if "library_ms" in k else ""))
    return row


def plain_stages(fin, d, pk, kw):
    """filter_plain on a frame's filter input `fin`, its planes kept after
    the vertical-edge deblock passes ("lf_v"), after both directions
    ("lf_h": CDEF's input) and after CDEF ("cdef": cdef_pass writes its
    planes in place)."""
    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.engine import programs as P

    out = {"lf_v": fin.clone()}
    real_lf, real_cdef = FL.lf_dir_pass, FL.cdef_pass
    vert = []  # the vertical passes' planes, in filter_plain's order 0, 1, 2

    def lf_dir_pass(plane, cmap, lmap, eih, luma, hor, bpc):
        res = real_lf(plane, cmap, lmap, eih, luma, hor, bpc)
        if not hor:
            out["lf_v"][len(vert)] = res
            vert.append(res)
        return res

    def cdef_pass(planes, *a):
        out["lf_h"] = planes.clone()
        out["cdef"] = real_cdef(planes, *a).clone()
        return planes

    FL.lf_dir_pass, FL.cdef_pass = lf_dir_pass, cdef_pass
    try:
        P.filter_plain(fin.clone(), d, pk.hdr, **kw)
    finally:
        FL.lf_dir_pass, FL.cdef_pass = real_lf, real_cdef
    return out


def form_ms(row, form):
    """A stage's device time through a form (filter_forms): the smaller of
    its profiler readings, None where the profiler showed none."""
    got = [v for v in row["dev"][form] if v is not None]
    return min(got) if got else None


@_filter_seconds
def lr_inputs(fin, d, pk, kw):
    """The loop restoration launches' inputs in filter_kernels on a frame's
    filter input: {"wiener": ..., "sgr": ...}, each (a copy of its output
    buffer as the launch finds it: the planes' copy, then with the Wiener
    stripes written; the planes and the snapshot it reads; its keywords),
    or None where the frame has no stripe of that filter; and
    filter_plain's planes, the self-guided launch's plain outcome."""
    import types

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import filters as FK

    rec = {"wiener": None, "sgr": None}

    def recorder(key, launch):
        def call(out, src, lpf, dev, hdr, **k):
            rec[key] = (out.clone(), src, lpf, k)
            launch(out, src, lpf, dev, hdr, **k)
        return call

    k = types.SimpleNamespace(
        lf_pass=FK.lf_pass, cdef_frame=FK.cdef_frame,
        superres_frame=FK.superres_frame,
        lr_wiener_frame=recorder("wiener", FK.lr_wiener_frame),
        lr_sgr_frame=recorder("sgr", FK.lr_sgr_frame))
    P.filter_kernels(fin.clone(), d, pk.hdr, k=k, **kw)
    return rec, P.filter_plain(fin.clone(), d, pk.hdr, **kw)[0]


def wiener_plain(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc):
    """The Wiener launch's plain outcome: a copy of `out` with each plane's
    Wiener stripes written by engine/filters.py lr_wiener_pass (from cat =
    the plane's and the snapshot's first ph rows), as filter_plain runs
    it."""
    import torch

    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.layout import LRB
    from rav1d_tpu_torch.ops.cuda import filters as FK

    want = out.clone()
    aw = out.shape[-1]
    for pl, wiener, _ in FK.lr_planes(hdr, layout_i):
        if not wiener:
            continue
        base, n = FK.lr_chunks(hdr, pl)["w"]
        dsc = P._region(dev, base, n * 16 * LRB).view(n, 16, LRB)
        dsc = dsc.permute(1, 0, 2).reshape(16, n * LRB)
        cat = torch.cat([src[pl][: phs[pl]], lpf[pl][: phs[pl]]])
        pf = torch.cat([want[pl].reshape(-1),
                        torch.zeros(1, dtype=want.dtype, device=want.device)])
        FL.lr_wiener_pass(pf, cat, dsc, Ws[pl], bpc, aw)
        want[pl] = pf[:-1].view(want[pl].shape)
    return want


def lr_wiener_planes(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc):
    """lr_wiener_frame through the earlier form: ops/cuda/filters.py
    lr_wiener_plane on each plane with Wiener stripes."""
    from rav1d_tpu_torch.ops.cuda import filters as FK

    for pl, wiener, _ in FK.lr_planes(hdr, layout_i):
        if wiener:
            FK.lr_wiener_plane(out[pl], src[pl], lpf[pl], dev, hdr, pl,
                               ph=phs[pl], W=Ws[pl], bpc=bpc)


def lr_sgr_planes(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc):
    """lr_sgr_frame through the earlier form: ops/cuda/filters.py
    lr_sgr_plane on each plane with self-guided stripes."""
    from rav1d_tpu_torch.ops.cuda import filters as FK

    for pl, _, sgr in FK.lr_planes(hdr, layout_i):
        if sgr:
            FK.lr_sgr_plane(out[pl], src[pl], lpf[pl], dev, hdr, pl,
                            ph=phs[pl], W=Ws[pl], bpc=bpc)


def filter_forms(label, fin, d, pk, kw):
    """Deblock by direction, CDEF, Wiener and the self-guided filter on a
    frame's filter input through the new kernels (the decoder path's) and
    the earlier forms (lf_pass_lines, cdef_frame_global, lr_wiener_plane
    and lr_sgr_plane on each plane), each stage's input taken from
    filter_plain (plain_stages; the loop restoration launches' from
    filter_kernels, lr_inputs, the Wiener launch's held to wiener_plain,
    the self-guided launch's to filter_plain's planes): every form's
    output must equal the plain stage's; then
    each stage's device time per form (torch.profiler, each direction's
    launches alone in their own windows) and its launches alone with
    their host calls (CUDA events), the forms in turns (new, earlier,
    earlier, new), every launch on a fresh copy of the stage's input,
    beside the stage's bound (filter_work) and its plain passes' time.
    Returns {stage: {...}}."""
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import filters as FK

    _, _, _, _, bh, bw, _ = kw["geom"]
    k = dict(bh=bh, bw=bw, layout_i=kw["layout_i"], bpc=kw["bpc"])
    st = plain_stages(fin, d, pk, kw)
    src = {"lf_v": fin, "lf_h": st["lf_v"], "cdef": st["lf_h"]}
    kern = {"lf_v": lambda f: lambda x: f(x, d, pk.hdr, False, **k),
            "lf_h": lambda f: lambda x: f(x, d, pk.hdr, True, **k),
            "cdef": lambda f: lambda x: f(x, src["cdef"], d, pk.hdr, **k)}
    forms = {"lf_v": (FK.lf_pass, FK.lf_pass_lines, "lf_rows_kernel",
                      "lf_pass_kernel", "lf", "lf_lines"),
             "lf_h": (FK.lf_pass, FK.lf_pass_lines, "lf_cols_kernel",
                      "lf_pass_kernel", "lf", "lf_lines"),
             "cdef": (FK.cdef_frame, FK.cdef_frame_global, "cdef_area_kernel",
                      "cdef_frame_kernel", "cdef", "cdef_global")}
    lr, st["sgr"] = lr_inputs(fin, d, pk, kw)

    def lr_stage(stage):  # binds the stage's recorded sources
        _, lr_src, lr_lpf, lr_kw = lr[stage]
        return lambda f: lambda x: f(x, lr_src, lr_lpf, d, pk.hdr, **lr_kw)

    if lr["wiener"] is not None:
        src["wiener"] = lr["wiener"][0]
        st["wiener"] = wiener_plain(*lr["wiener"][:3], d, pk.hdr,
                                    **lr["wiener"][3])
        kern["wiener"] = lr_stage("wiener")
        forms["wiener"] = (FK.lr_wiener_frame, lr_wiener_planes,
                           "lr_wiener_frame_kernel", "lr_wiener_kernel",
                           "wiener", "wiener_plane")
    if lr["sgr"] is not None:
        src["sgr"] = lr["sgr"][0]
        kern["sgr"] = lr_stage("sgr")
        forms["sgr"] = (FK.lr_sgr_frame, lr_sgr_planes, "lr_sgr_frame_kernel",
                        "lr_sgr_kernel", "sgr", "sgr_plane")
    work = filter_work(pk, kw)
    pieces = plain_pieces_ms(
        lambda: P.filter_plain(fin.clone(), d, pk.hdr, **kw))
    rows = {}
    for stage, (f_new, f_old, n_new, n_old, key_new, key_old) in forms.items():
        runs = {"new": kern[stage](f_new), "earlier": kern[stage](f_old)}
        for form, run in runs.items():
            x = src[stage].clone()
            run(x)
            err = max_err(x, st[stage])
            key = key_new if form == "new" else key_old
            FILT["err"][key] = max(FILT["err"][key], err)
            if err:
                raise AssertionError(f"{label}: {stage} through the {form} "
                                     f"kernel != the plain stage")
        # every timed launch on its own copy of the stage's input, made
        # before the window (a deblock pass filters its input in place)
        name = {"new": n_new, "earlier": n_old}
        dev = {f: [] for f in runs}
        ev = {f: [] for f in runs}

        def fresh(form, n):
            bufs = iter([src[stage].clone() for _ in range(n)])
            return lambda: runs[form](next(bufs))

        # launches a call: the earlier loop restoration forms' one per
        # plane with such stripes
        lrp = FK.lr_planes(pk.hdr, kw["layout_i"])
        per = {"new": 1, "earlier": {
            "wiener": sum(w for _, w, _ in lrp),
            "sgr": sum(s for _, _, s in lrp)}.get(stage, 1)}
        for form in ("new", "earlier", "earlier", "new"):
            # profiled_names_ms: a warm-up call and up to five windows of 5
            dev[form].append(profiled_names_ms(
                fresh(form, 26), 5, [name[form]], {name[form]: per[form]})[1][
                    name[form]])
            ev[form].append(cuda_ms(fresh(form, 11), 10))
        b_ms, b_by = bound(*work[stage])
        rows[stage] = dict(dev=dev, ev=ev, bound=b_ms, bound_by=b_by,
                           nbytes=work[stage][0], ops=work[stage][1],
                           plain_ms=pieces[stage])

    def txt(v):
        return "not measured" if v is None else f"{v:.4f}"

    for stage, r in rows.items():
        log(f"  forms {label} {stage}: new device "
            + "/".join(txt(v) for v in r["dev"]["new"]) + " ms, earlier "
            + "/".join(txt(v) for v in r["dev"]["earlier"]) + " ms "
            "(torch.profiler, in turns); launches alone new "
            + "/".join(f"{v:.4f}" for v in r["ev"]["new"]) + " ms, earlier "
            + "/".join(f"{v:.4f}" for v in r["ev"]["earlier"]) + " ms (CUDA "
            f"events); bound {r['bound']:.5f} ms ({r['bound_by']}: "
            f"{r['nbytes']} bytes, {r['ops']} ops); plain "
            f"{txt(r['plain_ms'])} ms; new == earlier == plain")
    return rows


def _rand_planes(rng, shape, bpc):
    """Pixels in range: a level per 16x16 region, a step of up to 4 << bd
    per 4x4 block, noise of +-1 << bd on half of the blocks, and sparse
    bright pixels (edges to filter, flat runs, speckles)."""
    import numpy as np

    bd = bpc - 8
    h, w = shape[-2:]
    lead = tuple(shape[:-2])

    def up(a, k):
        return a.repeat(k, -2).repeat(k, -1)[..., :h, :w]

    coarse = rng.integers(0, 1 << bpc, lead + ((h + 15) // 16,
                                               (w + 15) // 16))
    steps = rng.integers(-4, 5, lead + ((h + 3) // 4, (w + 3) // 4)) << bd
    rough = rng.integers(0, 2, steps.shape)
    v = (up(coarse, 16) + up(steps, 4)
         + (rng.integers(-1, 2, shape) << bd) * up(rough, 4)
         + (rng.random(shape) < 0.02) * (3 << bd))
    return np.clip(v, 0, (1 << bpc) - 1).astype(np.int32)


@_filter_seconds
def filter_kernel_phase(dev):
    """Each filter kernel against its plain version on the card, on random
    inputs at 8, 10 and 12 bits (4:2:0, 4:2:2, 4:4:4; and 8-bit 4:0:0),
    in hand-built blobs: both deblock directions over all planes (every
    width class, random levels with 0 and 63) through the new kernel and
    the earlier form against engine/filters.py lf_dir_pass per plane;
    CDEF through both forms against cdef_pass (random level maps: both
    strengths, either, neither); LR against lr_wiener_pass and
    lr_sgr_pass on a grid of stripes with a random kind each, the Wiener
    and the self-guided stripes each through their one-launch frame kernel
    and their earlier per-plane form; the superres upscale of random
    planes and snapshots (runs at 0 and at the largest value among them)
    at 8, 10 and 12 bits in 4:0:0, 4:2:0, 4:2:2 and 4:4:4 at every
    denominator 9-16 (steps and starts as the decoder computes them; a
    613-column upscaled width, three blocks of columns a row) against
    programs._superres. Bit-identical required; the largest difference
    per kernel goes into FILT."""
    import numpy as np
    import torch

    from rav1d_tpu_torch.engine import filters as FL
    from rav1d_tpu_torch.engine.layout import CDEF0, DB0, HDR_LEN, LR0, LRB
    from rav1d_tpu_torch.ops.cuda import filters as FK
    from rav1d_tpu_torch.ops.ref.lf import calc_eih
    from rav1d_tpu_torch.tables.spec_data import SGR_PARAMS

    def t(a):
        return torch.from_numpy(np.array(a, np.int32)).to(dev)

    def check(key, got, want):
        err = max_err(got, want)
        FILT["err"][key] = max(FILT["err"][key], err)
        if err:
            raise AssertionError(f"{key} kernel != plain at {bpc} bpc")

    for bpc, layout_i in ((8, 1), (10, 2), (12, 3), (8, 0)):
        rng = np.random.default_rng((1000 if layout_i else 3000) + bpc)
        bd = bpc - 8
        ss_hor, ss_ver = FK.subsampling(layout_i)
        bh, bw = 34, 50
        ah, aw = 4 * bh, 4 * bw
        planes = _rand_planes(rng, (3, ah, aw), bpc)
        hdr = np.zeros(HDR_LEN, np.int32)
        words = [np.zeros(HDR_LEN, np.int32)]
        pos = [HDR_LEN]

        def add(a):
            a = np.asarray(a, np.int32).reshape(-1)
            words.append(a)
            pos[0] += a.size
            return pos[0] - a.size

        def add_u8(b):
            b = np.asarray(b, np.uint8).reshape(-1)
            return add(np.pad(b, (0, -b.size % 4)).view("<i4"))

        eih = np.array(calc_eih(bpc % 5), np.int32)
        hdr[DB0] = add(eih)
        shapes = [(bh, bw)] + [((bh + ss_ver) >> ss_ver,
                                (bw + ss_hor) >> ss_hor)] * 2
        maps = {}
        for hor in (0, 1):
            for p, (nh, nw) in enumerate(shapes):
                if hor:
                    nh, nw = nw, nh
                cls = rng.integers(0, 4, (nh, nw))
                lvl = rng.integers(0, 64, (nh, nw))
                lvl[rng.random((nh, nw)) < 0.1] = 63
                maps[hor, p] = (cls, lvl)
                hdr[DB0 + 1 + 3 * hor + p] = add_u8((cls << 6) | lvl)
        nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
        ylvl = rng.integers(0, 64, (nby, nbx)) * (rng.random((nby, nbx)) < .8)
        uvlvl = rng.integers(0, 64, (nby, nbx)) * (rng.random((nby, nbx)) < .8)
        hdr[CDEF0] = add_u8(ylvl)
        hdr[CDEF0 + 1] = add_u8(uvlvl)
        hdr[CDEF0 + 2] = damping = 3 + bpc % 4 + bd
        # LR: 64-pixel units over the visible plane, 56- then 64-row
        # stripes, a random kind each (pack.py _collect_lr's geometry)
        ph, W = ah - 6, 96
        slots = {}
        for p in range(3):
            vw = aw if p == 0 else (aw + ss_hor) >> ss_hor
            vh = ph if p == 0 else (ph + ss_ver) >> ss_ver
            y = 0
            while y < vh:
                sh = min((64 - 8 * (y == 0)) >> (ss_ver if p else 0), vh - y)
                for x in range(0, vw, 64):
                    w = min(64, vw - x)
                    kind = ("w", 0, 1, 2)[int(rng.integers(0, 4))]
                    hl, hr = x > 0, x + w < vw
                    top = (y, y) if y == 0 else (vh + y - 2, vh + y - 1)
                    below = y + sh
                    bot = ((below - 1, below - 1) if below == vh else
                           (vh + below, vh + min(below + 1, vh - 1)))
                    if kind == "w":
                        prm = [int(rng.integers(a, b + 1)) for a, b in
                               zip((-5, -23, -17) * 2, (10, 8, 46) * 2)]
                    else:
                        row = SGR_PARAMS[int(rng.integers(0, 14))]
                        w0 = int(rng.integers(-96, 32))
                        prm = [int(row[0]), int(row[1]), w0,
                               128 - w0 - int(rng.integers(-32, 96)), 0, 0]
                    slots.setdefault((p, kind), []).append(
                        [x, y, w, sh, x - 3 * hl, x + w - 1 + 3 * hr, *top,
                         *bot, *prm])
                y += sh
        for (p, kind), cols in slots.items():
            d = np.asarray(cols, np.int32).T
            nc = (d.shape[1] + LRB - 1) // LRB
            ch = np.zeros((16, nc * LRB), np.int32)
            ch[:, : d.shape[1]] = d
            i = 4 * p + FK.KINDS.index(kind)
            hdr[LR0 + 2 * i] = add(ch.reshape(16, nc, LRB).transpose(1, 0, 2))
            hdr[LR0 + 2 * i + 1] = nc
            slots[p, kind] = t(ch)
        blob = np.concatenate(words + [np.zeros(16, np.int32)])
        blob[:HDR_LEN] = hdr
        blob = t(blob)
        kw = dict(bh=bh, bw=bw, layout_i=layout_i, bpc=bpc)

        nplanes = 1 if layout_i == 0 else 3
        got, old, want = t(planes), t(planes), t(planes)
        for hor in (0, 1):
            FK.lf_pass(got, blob, hdr, bool(hor), **kw)
            FK.lf_pass_lines(old, blob, hdr, bool(hor), **kw)
            for p in range(nplanes):
                cls, lvl = maps[hor, p]
                want[p] = FL.lf_dir_pass(want[p], t(cls), t(lvl), t(eih),
                                         p == 0, bool(hor), bpc)
        check("lf", got, want)
        check("lf_lines", old, want)

        sec = np.where((ylvl & 3) == 3, 4, ylvl & 3) << bd
        usec = np.where((uvlvl & 3) == 3, 4, uvlvl & 3) << bd
        cmaps = t(np.stack([(ylvl >> 2) << bd, sec, uvlvl,
                            (uvlvl >> 2) << bd, usec]))
        got, old, want = t(planes), t(planes), t(planes)
        FK.cdef_frame(got, t(planes), blob, hdr, **kw)
        FK.cdef_frame_global(old, t(planes), blob, hdr, **kw)
        FL.cdef_pass(want, cmaps, damping, nby, nbx, bh, bw, ss_hor, ss_ver,
                     -1 if nplanes == 1 else (1 if layout_i == 2 else 0), bpc)
        check("cdef", got, want)
        check("cdef_global", old, want)

        # loop restoration (4:0:0: the luma plane's stripes only)
        src, lpf = t(planes), t(_rand_planes(rng, (3, ah, aw), bpc))
        phs = tuple(ph if p == 0 else (ph + ss_ver) >> ss_ver
                    for p in range(3))
        lw = dict(layout_i=layout_i, phs=phs, Ws=(W,) * 3, bpc=bpc)
        # each filter: every plane in one launch, and per plane through
        # the earlier form
        for key, kinds, frame, per_plane in (
                ("wiener", ("w",), FK.lr_wiener_frame, lr_wiener_planes),
                ("sgr", (0, 1, 2), FK.lr_sgr_frame, lr_sgr_planes)):
            got, old = src.clone(), src.clone()
            want = torch.cat([src.reshape(3, -1), torch.zeros(
                (3, 1), dtype=torch.int32, device=dev)], 1)
            for p in range(nplanes):
                if not any((p, k) in slots for k in kinds):
                    continue
                vh = phs[p]
                cat = torch.cat([src[p, :vh], lpf[p, :vh]])
                pf = want[p].clone()
                for k in kinds:
                    if k == "w" and (p, k) in slots:
                        FL.lr_wiener_pass(pf, cat, slots[p, k], W, bpc, aw)
                    elif (p, k) in slots:
                        FL.lr_sgr_pass(pf, cat, slots[p, k], W, k, bpc, aw)
                want[p] = pf
            want = want[:, :-1].reshape(3, ah, aw)
            frame(got, src, lpf, blob, hdr, **lw)
            per_plane(old, src, lpf, blob, hdr, **lw)
            check(key + "_plane", old, want)
            check(key, got, want)
            if torch.equal(want, src):
                raise AssertionError(f"{key}: the stripes changed nothing")

    from rav1d_tpu_torch.decoder import _scale_fac
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine.layout import SR0
    from rav1d_tpu_torch.recon.superres import get_upscale_x0

    sr_w, cur_h = 613, 37
    ah, aw = 40, 624
    s_ah, s_aw = 44, 640
    cases = 0
    for bpc in (8, 10, 12):
        rng = np.random.default_rng(2000 + bpc)
        pxmax = (1 << bpc) - 1
        for layout_i in (0, 1, 2, 3):
            ss_hor, ss_ver = FK.subsampling(layout_i)
            for denom in range(9, 17):
                coded = max((sr_w * 8 + (denom >> 1)) // denom, 16)
                hdr = np.zeros(HDR_LEN, np.int32)
                for ci, sh in ((0, 0), (1, ss_hor)):
                    i, o = (coded + sh) >> sh, (sr_w + sh) >> sh
                    hdr[SR0 + 2 * ci] = step = _scale_fac(i, o)
                    hdr[SR0 + 2 * ci + 1] = get_upscale_x0(i, o, step)
                pl_in = []
                for _ in range(2):
                    v = _rand_planes(rng, (3, ah, aw), bpc)
                    run = rng.integers(0, 4, (3, ah, aw // 8)).repeat(8, -1)
                    v = np.where(run == 0, 0, np.where(run == 1, pxmax, v))
                    pl_in.append(t(v))
                geom = (s_ah, s_aw, sr_w, cur_h, ((coded + 7) >> 3) << 3)
                got = FK.superres_frame(*pl_in, hdr, cur_h=cur_h,
                                        sr_geom=geom, layout_i=layout_i,
                                        bpc=bpc)
                want = torch.stack(P._superres(
                    *pl_in, hdr, cur_h, geom, ss_hor, ss_ver, layout_i != 0,
                    bpc)[:2])
                err = max_err(got, want)
                FILT["err"]["sr"] = max(FILT["err"]["sr"], err)
                if err:
                    raise AssertionError(f"sr kernel != plain at {bpc} bpc, "
                                         f"layout {layout_i}, denominator "
                                         f"{denom}")
                cases += 1
    log(f"filter kernel phase: deblock, CDEF, Wiener and the self-guided "
        f"filter (both forms each) bit-identical to their plain versions "
        f"at 8, 10 and 12 bits (and in 4:0:0), the superres "
        f"kernel to programs._superres in {cases} cases "
        f"(max |err| {json.dumps(FILT['err'])})")


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
                                   blobs=blobs,
                                   wave_check=(0,) if "12bit" in name else (),
                                   time_wave=True, time_inter=True)
        launches += n
        worst = max(worst, err)
    return launches, worst, blobs


UHD_W, UHD_H = 3840, 2160
# the 2160p phase's results: per timed frame its kernels' rows and its
# upload's device half; the launches in the decodes and the largest
# difference from the plain versions per kernel; the decodes' host sides
# (HostSpy); the phase's seconds; the timed frames' labels ("still",
# "main")
UHD = {"rows": {}, "launches": {}, "err": {}, "host": [], "seconds": 0.0}
# the seven kernels on the 2160p path: (key, profiler names, entry, source,
# the TPU kernel it replaces, the stream whose timed frame the kernels
# line reads)
UHD_KERNELS = (
    ("itx", ("itx_frame_kernel",), "rav1d_itx_frame", "itx.cu",
     "rav1d_tpu/ops/pallas/itx_all.py:110", "still"),
    ("wave", ("wave_frame_kernel",), "rav1d_wave_frame", "wave.cu",
     "rav1d_tpu/engine/mega.py:213", "still"),
    ("inter", ("inter_batch_kernel",), "rav1d_inter_batches", "inter.cu",
     "rav1d_tpu/engine/mega.py:466", "inter"),
    ("lf", ("lf_rows_kernel", "lf_cols_kernel"), "rav1d_deblock", "lf.cu",
     "rav1d_tpu/engine/filters.py:34", "still"),
    ("cdef", ("cdef_area_kernel",), "rav1d_cdef", "cdef.cu",
     "rav1d_tpu/engine/filters.py:84", "still"),
    ("wiener", ("lr_wiener_frame_kernel",), "rav1d_lr_wiener_frame", "lr.cu",
     "rav1d_tpu/engine/filters.py:246", "still"),
    ("sgr", ("lr_sgr_frame_kernel",), "rav1d_lr_sgr_frame", "lr.cu",
     "rav1d_tpu/engine/filters.py:253", "still"),
)


def launch_readings(fn, names, reps, readings=5):
    """{name: (median device ms a launch, launches the profiler saw,
    launches made)} of the kernels whose names contain each of `names`,
    over `readings` torch.profiler windows of `reps` calls of fn each (fn
    takes the reading's call number); a reading is each window's mean per
    launch that it saw, so a window that drops launches' records does not
    shrink it. None where no window saw a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    got = {n: [] for n in names}
    seen = dict.fromkeys(names, 0)
    made = dict.fromkeys(names, 0)
    for r in range(readings):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(reps):
                fn(1 + r * reps + k)
            torch.cuda.synchronize()
        for n in names:
            us = cnt = 0
            for e in prof.key_averages():
                if (getattr(e, "device_type", None) == DeviceType.CUDA
                        and n in e.key):
                    t = getattr(e, "device_time_total", None)
                    us += e.cuda_time_total if t is None else t
                    cnt += e.count
            made[n] += reps
            seen[n] += cnt
            if cnt and us:
                got[n].append(us / cnt / 1e3)

    def median(v):
        v = sorted(v)
        return (v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2 if v else None

    return {n: (median(got[n]), seen[n], made[n]) for n in names}


def upload_parts(pk, psz, bpc, dev, reps=5):
    """The device half of a frame's upload (engine/blob.py Uploader.upload)
    alone, ms a call (CUDA events, the median of `reps`): the zero fill of
    the blob's capacity (torch.zeros) and the host-to-device copy of the
    used prefix from the pinned staging buffer; the host half (the staging
    wait and pack.write_into) is read inside the decodes (HostSpy)."""
    import torch

    from rav1d_tpu_torch.engine.blob import bucket_pow2, det_cap_words

    n = pk.blob.pos
    cap = bucket_pow2(max(n, pk.hdr.size, det_cap_words(psz, bpc)))
    buf = torch.empty(n, dtype=torch.int32, pin_memory=True)
    pk.write_into(buf.numpy())
    d = torch.zeros(cap, dtype=torch.int32, device=dev)

    def zero():
        torch.zeros(cap, dtype=torch.int32, device=dev)

    def copy():
        d[:n].copy_(buf, non_blocking=True)

    zs = sorted(cuda_ms(zero, 1) for _ in range(reps))
    cs = sorted(cuda_ms(copy, 1) for _ in range(reps))
    return dict(words=n, cap=cap, zero_fill=zs[reps // 2], h2d=cs[reps // 2])


class HostSpy:
    """While installed, the host side of each decoded frame, on the host
    clock (perf_counter, ms), summed until `take`: each engine/blob.py
    Uploader._buffer call ("wait": the wait for the previous frame's copy
    to leave the staging buffer, or the allocation of a larger one), each
    FramePack.write_into call from Uploader.upload ("write_into": the
    host's copy of the blob into the staging buffer), each
    programs.wave call ("wave_host": the palette scatter and the wave
    kernel's arguments and launch, what engine/run.py's wave span charges
    besides the kernel), and the interpreter's garbage collections
    ("gc_ms" by generation, "gc_in_wave": those inside programs.wave)."""

    def __enter__(self):
        import gc

        from rav1d_tpu_torch.engine import programs as P
        from rav1d_tpu_torch.engine.blob import Uploader
        from rav1d_tpu_torch.engine.pack import FramePack

        self.gc, self.P, self.U, self.F = gc, P, Uploader, FramePack
        self.real = (Uploader._buffer, FramePack.write_into, P.wave)
        real_buffer, real_write, real_wave = self.real
        self.cur, self.t_gc, self.in_wave = self._new(), None, False

        def add(k, t0):
            self.cur[k] += (time.perf_counter() - t0) * 1e3

        def _buffer(up, n):
            t0 = time.perf_counter()
            try:
                return real_buffer(up, n)
            finally:
                add("wait", t0)
                self.in_upload = True

        def write_into(pk, buf):
            t0 = time.perf_counter()
            try:
                return real_write(pk, buf)
            finally:
                if self.in_upload:  # Uploader.upload's, not a test's
                    add("write_into", t0)
                    self.in_upload = False

        def wave(*a, **kw):
            t0 = time.perf_counter()
            self.in_wave = True
            try:
                return real_wave(*a, **kw)
            finally:
                self.in_wave = False
                add("wave_host", t0)

        def on_gc(phase, info):
            if phase == "start":
                self.t_gc = time.perf_counter()
            elif self.t_gc is not None:
                ms = (time.perf_counter() - self.t_gc) * 1e3
                self.cur["gc_ms"][str(info["generation"])] += ms
                if self.in_wave:
                    self.cur["gc_in_wave"] += ms

        self.in_upload = False
        self.on_gc = on_gc
        gc.callbacks.append(on_gc)
        Uploader._buffer, FramePack.write_into, P.wave = (_buffer, write_into,
                                                          wave)
        return self

    @staticmethod
    def _new():
        return dict(wait=0.0, write_into=0.0, wave_host=0.0,
                    gc_ms={"0": 0.0, "1": 0.0, "2": 0.0}, gc_in_wave=0.0)

    def take(self):
        """What was summed since the last take, rounded."""
        out, self.cur = self.cur, self._new()
        out["gc_ms"] = {k: round(v, 3) for k, v in out["gc_ms"].items()}
        return {k: (v if isinstance(v, dict) else round(v, 3))
                for k, v in out.items()}

    def __exit__(self, *exc):
        self.gc.callbacks.remove(self.on_gc)
        (self.U._buffer, self.F.write_into, self.P.wave) = self.real


def uhd_timing(key, fr):
    """On one 2160p engine frame's checked inputs (stream_on_card's
    on_frame), for each kernel of UHD_KERNELS (the inter kernel on an
    inter frame): its device time a launch (launch_readings:
    torch.profiler, the median of five windows' means, with the launches
    each saw and made), every call on its own input (the in-place kernels
    on fresh copies), its plain version's time on the same input (CUDA
    events; the plain wavefront's from stream_on_card where it ran), and
    its bound from this frame's data (itx_frame_work, wave_work,
    inter_work, filter_work); the wave kernel's barrier-only floor
    (device time); and the upload's device half (upload_parts). Rows into
    UHD["rows"][key]."""
    import torch

    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.ops.cuda import filters as FK
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.ops.cuda import wave as WK

    f, plan, pk, d, ra = fr["f"], fr["plan"], fr["pk"], fr["d"], fr["ra"]
    planes, kw, fin, fkw = fr["planes"], fr["kw"], fr["fin"], fr["fkw"]
    ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
    hdr = pk.hdr
    n0 = (I.launches, WK.launches, IK.launches, FK.lf_launches,
          FK.cdef_launches, FK.wiener_launches, FK.sgr_launches)
    reps = 3
    row = {}
    kernel_names = {k: names for k, names, *_ in UHD_KERNELS}

    def put(kern, fn, plain_ms, nbytes, ops, **extra):
        names = kernel_names[kern]
        got = launch_readings(fn, names, reps)
        ms = [got[n][0] for n in names]
        b_ms, b_by = bound(nbytes, ops)
        row[kern] = dict(ms=None if None in ms else sum(ms),
                         seen={n: got[n][1] for n in names},
                         made={n: got[n][2] for n in names},
                         plain_ms=plain_ms, nbytes=nbytes, ops=ops,
                         bound=b_ms, bound_by=b_by, **extra)

    words = pk.words()
    buf = torch.zeros(6 * ah * aw, dtype=torch.int32, device=d.device)
    put("itx", lambda _: I.itx_frame(d, hdr, pk.tx_valid, buf, aw, bpc),
        cuda_ms(lambda: P.resid_plain(d, hdr, pk.tx_valid, ah=ah, aw=aw,
                                      bpc=bpc), 1),
        *itx_frame_work(words, hdr, pk.tx_valid, bpc))
    pf = P.palette_pf(planes, d, hdr)
    wk = wave_kw(kw)
    bar = launch_readings(
        lambda _: WK.barrier_frame(pf, ra, d, hdr, pk.waves, **wk),
        ["wave_barrier_kernel"], reps)["wave_barrier_kernel"]
    put("wave", lambda _: P.wave(planes, ra, d, hdr, pk.waves, **kw),
        fr["plain_ms"], *wave_work(pk, kw["ss_hor"], kw["ss_ver"]),
        levels=len(WK.levels(pk.waves)), grid=WK.grid(pk.waves),
        barrier_ms=bar[0], barrier_seen=bar[1])
    if pk.srcs is not None:
        (sY, sC), g = inter_inputs(f, plan, pk, d)
        args = (ra, d, hdr, pk.inter_runs, sY, sC)

        def zeros():
            return torch.zeros((3, ah, aw), dtype=torch.int32,
                               device=d.device)

        xs = [zeros() for _ in range(1 + 5 * reps)]
        call = fresh(zeros, 2)
        plain = cuda_ms(lambda: call(lambda x: P.inter_plain(x, *args, **g)),
                        1)
        put("inter", lambda i: P.inter(xs[i], *args, **g), plain,
            *inter_work(pk, g),
            tiles=sum(r.n for v in pk.inter_runs.values() for r in v))
        del xs
    # the filters, each on its stage's input: deblock on the wave
    # program's output (fresh copies: it works in place), CDEF on the
    # kernels' deblocked planes, loop restoration on CDEF's output and the
    # deblocked snapshot
    k = dict(bh=f.bh, bw=f.bw, layout_i=fkw["layout_i"], bpc=bpc)
    work = filter_work(pk, fkw)
    pieces = plain_pieces_ms(
        lambda: P.filter_plain(fin.clone(), d, hdr, **fkw))
    ins = [fin.clone() for _ in range(1 + 5 * reps)]

    def lf(i):
        FK.lf_pass(ins[i], d, hdr, False, **k)
        FK.lf_pass(ins[i], d, hdr, True, **k)

    put("lf", lf, pieces["lf"], *work["lf"])
    del ins
    x = fin.clone()
    FK.lf_pass(x, d, hdr, False, **k)
    FK.lf_pass(x, d, hdr, True, **k)
    pre = x.clone()
    out = pre.clone()
    put("cdef", lambda _: FK.cdef_frame(out, pre, d, hdr, **k),
        pieces["cdef"], *work["cdef"])
    FK.cdef_frame(x, pre, d, hdr, **k)
    vis_h = fkw["geom"][6]
    ss_ver = FK.subsampling(fkw["layout_i"])[1]
    lk = dict(layout_i=fkw["layout_i"], bpc=bpc,
              phs=tuple((vis_h + sv) >> sv for sv in (0, ss_ver, ss_ver)),
              Ws=(fkw["lr_ws"][0],) + (fkw["lr_ws"][1],) * 2)
    w_n, s_n = FK.lr_launches(hdr, fkw["layout_i"])
    for key_, entry, n_ in (("wiener", FK.lr_wiener_frame, w_n),
                            ("sgr", FK.lr_sgr_frame, s_n)):
        if n_:
            out = x.clone()
            put(key_, lambda _, e=entry: e(out, x, pre, d, hdr, **lk),
                pieces[key_], *work[key_])
    # these launches are outside the decodes, whose counts are reset
    (I.launches, WK.launches, IK.launches, FK.lf_launches, FK.cdef_launches,
     FK.wiener_launches, FK.sgr_launches) = n0
    up = upload_parts(pk, ah * aw, bpc, d.device)

    def txt(v, fmt="%.5f ms"):
        return "not measured" if v is None else fmt % v

    for kk, r in row.items():
        extra = ""
        if kk == "wave":
            per = None if r["ms"] is None else r["ms"] * 1e3 / r["levels"]
            extra = (f", {r['levels']} levels, grid {r['grid']} blocks, "
                     f"{txt(per, '%.3f us')} a level; barrier-only floor "
                     f"{txt(r['barrier_ms'])} (saw {r['barrier_seen']} "
                     "launches)")
        if kk == "inter":
            extra = f", {r['tiles']} tiles"
        log(f"  uhd {key} {kk}: device {txt(r['ms'])} a launch (median of "
            f"five torch.profiler windows; launches seen {r['seen']} of "
            f"{r['made']}), plain {txt(r['plain_ms'], '%.1f ms')}, bound "
            f"{r['bound']:.5f} ms ({r['bound_by']}: {r['nbytes']} bytes, "
            f"{r['ops']} ops){extra}")
    log(f"  uhd {key} upload's device half: {json.dumps(up)}")
    UHD["rows"][key] = dict(row, upload=up)


def uhd_phase(dev):
    """The 2160p path (smoke_digests.json "uhd"): (a) a 3840x2160 10-bit
    4:2:0 still in one tile, the format of the JAX bench's 4k_10bit_intra
    configuration, and (b) a 3840x2160 8-bit 4:2:0 key frame and two inter
    frames with every inter tool in four tile columns, through
    stream_on_card, captured on the engine (the capture's decode held to
    the committed digests: rav1d_tpu's host path's, a CPU test holds
    them), with no fallback and no host reference upload: resid, inter
    and filter_ held to their plain versions on every frame, each frame's
    own launches in the decode. The plain wavefront runs once, on (a) (a
    2160p frame takes tens of seconds); the MD5s hold the wave kernel on
    the other frames. Timed
    (uhd_timing) on (a) and on (b)'s first inter frame: each of the seven
    kernels' device time a launch, its plain version, its bound, the wave
    kernel's barrier-only floor and the upload's device half; inside the
    decodes (HostSpy) the host side: the upload's host half, the wave
    span's host call and the interpreter's garbage collections. Returns
    (itx launches, max |err| of ra)."""
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import run

    t0 = time.perf_counter()
    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    uhd = digests["uhd"]
    if (uhd["width"], uhd["height"]) != (UHD_W, UHD_H):
        raise AssertionError("smoke_digests.json's uhd streams are for "
                             "another picture size")
    launches = worst = 0
    n_w0, n_i0, n_f0 = WAVE["launches"], INTER["launches"], dict(
        FILT["launches"])
    for name in sorted(uhd["streams"]):
        inter = uhd["streams"][name]["kind"] == "inter_sequence"
        label = f"{name} {UHD_W}x{UHD_H}"
        timed = f"{label} frame {1 if inter else 0}"
        UHD["main" if inter else "still"] = timed

        def on_frame(key, fr, timed=timed):
            if key == timed:
                uhd_timing(key, fr)

        def on_decode(i, ms, label=label):
            UHD["host"].append(dict(spy.take(), frame=f"{label} frame {i}",
                                    wall_ms=round(ms, 1),
                                    stage_ms={k: round(v, 3) for k, v in
                                              run.stage_ms.items()}))

        spy = HostSpy()
        n, err, _ = stream_on_card(
            dev, label, synth.uhd_stream(digests, name),
            want=uhd["streams"][name]["md5"],
            wave_check=() if inter else (0,), on_frame=on_frame,
            on_decode=on_decode, capture_on_card=True, spy=spy)
        launches += n
        worst = max(worst, err)
    for r in UHD["host"]:
        log(f"  uhd host side of the decode: {json.dumps(r)}")
    UHD["launches"] = dict(
        itx=launches, wave=WAVE["launches"] - n_w0,
        inter=INTER["launches"] - n_i0,
        **{k: FILT["launches"][k] - n_f0[k]
           for k in ("lf", "cdef", "wiener", "sgr")})
    UHD["err"] = dict(itx=worst, wave=WAVE["err"], inter=INTER["err"],
                      lf=0, cdef=0, wiener=0, sgr=0)
    UHD["seconds"] = time.perf_counter() - t0
    log(f"uhd: launches in the decodes {json.dumps(UHD['launches'])}; the "
        f"phase took {UHD['seconds']:.1f} s")
    return launches, worst


def uhd_kernels():
    """The kernels line's 2160p entries: the inter kernel's on (b)'s
    first inter frame, the others' on (a)."""
    out = []
    for key, _, entry, src, replaces, stream in UHD_KERNELS:
        r = UHD["rows"][UHD["main" if stream == "inter" else "still"]][key]
        out.append({
            "name": f"{entry} {UHD_W}x{UHD_H}", "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": UHD["launches"][key], "max_abs_err": UHD["err"][key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    return out


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
    return 0 after one itx launch per frame, one inter launch per inter
    frame and no inter_plain call, one wave frame launch per frame with
    wave items, no level launch and no class_step call. Returns the itx
    launches."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import cli, synth
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine import wave as TW
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.ops.cuda import wave as WK

    packets = synth.inter_sequence(FMT_W, FMT_H, 8)
    captured = synth.capture_frames(packets)
    nframes, ninter = wave_frames(captured), inter_frames(captured)
    path = os.path.join(tmp, "cli.ivf")
    synth.write_ivf(path, packets, FMT_W, FMT_H)
    md5 = synth.stream_md5(packets)
    times = os.path.join(tmp, "frametimes.txt")
    fb = T.engine.stats["fallback"]
    I.launches = WK.launches = WK.level_launches = TW.calls = 0
    IK.launches = IK.earlier_launches = P.inter_plain_calls = 0
    reset_filter_counts()
    with FilterRecorder() as rec, InterRecorder() as irec:
        t0 = time.perf_counter()
        rc = cli.main(["-i", path, "--verify", md5, "--frametimes", times])
        wall = time.perf_counter() - t0
    launches = I.launches
    w_launches, w_level, w_calls = WK.launches, WK.level_launches, TW.calls
    i_launches, i_plain = IK.launches, P.inter_plain_calls
    i_earlier = IK.earlier_launches
    check_filter_counts("cli", filter_counts(), filter_want(rec.check("cli")))
    i_checked = irec.check("cli")
    WAVE["launches"] += w_launches
    INTER["launches"] += i_launches
    with open(times) as fh:
        ms = [int(v) / 1e6 for v in fh.read().split()]
    log(f"cli {FMT_W}x{FMT_H}: --verify {md5} rc {rc}, {wall:.2f} s, "
        f"frametimes ms {[round(v, 3) for v in ms]}, itx launches "
        f"{launches}, inter launches {i_launches} for {ninter} inter frames "
        f"({i_checked} equal to inter_plain after the decode), inter_plain "
        f"calls {i_plain}, wave frame launches {w_launches} for "
        f"{nframes} frames, level launches {w_level}, class_step calls "
        f"{w_calls}, fallback {T.engine.stats['fallback'] - fb}")
    if rc != 0 or launches != len(packets) or len(ms) != len(packets):
        raise AssertionError("cli: --verify failed, or not one itx launch "
                             "and one frame time per frame")
    if w_launches != nframes or w_level or w_calls:
        raise AssertionError("cli: not one wave frame launch per frame, or "
                             "a level launch or a class_step call")
    if i_launches != ninter or i_plain or i_checked != ninter or i_earlier:
        raise AssertionError("cli: not one inter launch per inter frame, or "
                             "an inter_plain call or a launch of the earlier "
                             "inter form")
    return launches


PIPE = {}  # the pipeline phase's counts, for the kernels line


def ring_decode(dev, packets, d, times=None):
    """One Decoder(max_frame_delay=d) decode of `packets` on the card, as
    dav1d's CLI calls it (one get_picture per send_data, then the drain
    handshake). Returns (the MD5s in output order, the decode order's
    fallback frames, what it added to the counters). With `times`, a dict,
    it also puts there, in ms, the stream's wall; on the caller's thread
    the time in send_data, in get_picture (waiting for the ring and the
    fetch) and, inside send_data, in recon/frame.py decode_frame_syntax;
    the dense passes' time (the ring's worker's busy time when d > 1) and,
    inside it, recon/frame.py materialize_work_items and engine/plan.py
    build_plan (the planner); each timed by wrappers installed here, not
    by the package."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import kernels
    from rav1d_tpu_torch.engine import plan as PL
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine import wave as TW
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.ops.cuda import wave as WK
    from rav1d_tpu_torch.recon import frame as RF

    t = dict.fromkeys(("wall", "send", "get", "syntax", "dense",
                       "work_items", "plan"), 0.0)
    results = []
    real = (T.engine.run_dense, RF.decode_frame_syntax,
            RF.materialize_work_items, PL.build_plan)

    def run_dense(tc, f, up):  # decode order: the ring is FIFO
        ok = real[0](tc, f, up)
        results.append(ok)
        return ok

    def timed(key, fn):
        def call(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                t[key] += time.perf_counter() - t0
        return call

    class Timed(T.Decoder):
        def _decode_dense(self, f):
            t0 = time.perf_counter()
            super()._decode_dense(f)
            t["dense"] += time.perf_counter() - t0

    def counts():
        return dict(T.engine.stats, itx=I.launches, wave=WK.launches,
                    level=WK.level_launches, class_step=TW.calls,
                    plain=kernels.calls, inter=IK.launches,
                    inter_earlier=IK.earlier_launches,
                    inter_plain=P.inter_plain_calls, **filter_counts())

    before = counts()
    (T.engine.run_dense, RF.decode_frame_syntax, RF.materialize_work_items,
     PL.build_plan) = (run_dense, timed("syntax", real[1]),
                       timed("work_items", real[2]), timed("plan", real[3]))
    out = []
    try:
        dec = Timed(T.Settings(apply_grain=False, max_frame_delay=d),
                    device=dev)
        send = timed("send", dec.send_data)
        get_picture = timed("get", dec.get_picture)

        def get():
            try:
                out.append(synth.picture_md5(get_picture()))
                return True
            except T.EAgain:
                return False

        t0 = time.perf_counter()
        for data in packets:
            send(data)
            get()
        misses = 0
        while misses < 2:
            misses = 0 if get() else misses + 1
        t["wall"] = time.perf_counter() - t0
        dec.close()
    finally:
        (T.engine.run_dense, RF.decode_frame_syntax,
         RF.materialize_work_items, PL.build_plan) = real
    after = counts()
    if times is not None:
        times.update({k: v * 1e3 for k, v in t.items()})
    return (out, [i for i, ok in enumerate(results) if not ok],
            {k: after[k] - before[k] for k in after})


def pipeline_phase(dev):
    """The frame ring (decoder.py: the dense pass on a FIFO worker, the
    async pinned fetch, the delayed-output ring). Correctness: the 8-bit
    and 10-bit 1080p inter sequences, the 640x360 2x2-tile header-tools
    sequence, the 640x360 superres sequence (its fourth frame falls back
    to the host path and reads engine-decoded references on the worker)
    and a 640x360 intrabc sequence (its key frame falls back), each at
    delays 2 and 3 under torch.cuda.set_sync_debug_mode("error") (any
    host synchronisation on the worker's path fails its dense pass, which
    the decoder raises), must equal delay 1: MD5s, fallback frames, engine
    stats, itx and wave frame launches, no level launch, no class_step or
    plain transform call. Timing: the 1080p 8-bit sequence's packets three
    times over (9 units, every third a key frame, held to the committed
    digests) at delays 1, 2, 3, then 1 again, and at delay 2 with a 0.5 ms
    switch interval: the stream's wall, its mean per frame, the caller's
    thread's times (send_data, the syntax pass, get_picture), the dense
    passes' time (the worker's busy time at d > 1) with the planner's and
    pack's shares, and the frame stages' CUDA-event sum. Returns the itx
    launches of its decodes."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import run
    from rav1d_tpu_torch.synth import Tools

    with open(os.path.join(HERE, "rav1d_tpu_torch", "smoke_digests.json")) as fh:
        digests = json.load(fh)
    inter = synth.inter_sequence(W, H, digests["inter"]["seed"])
    ten = next(n for n in sorted(digests["formats"]) if "10bit" in n)
    streams = [
        (f"inter 8-bit {W}x{H}", inter),
        (f"{ten} {W}x{H}", synth.smoke_stream(digests, ten)),
        (f"headers 8-bit sb128 {FMT_W}x{FMT_H}", synth.inter_sequence(
            FMT_W, FMT_H, 6, tools=Tools(
                sb128=True, delta_lf_multi=True, tiles=(1, 1),
                segmentation=True, delta_q=True, lf_deltas=True,
                tx_mode_largest=True))),
        (f"superres {FMT_W}x{FMT_H}", synth.inter_sequence(
            FMT_W, FMT_H, 2, superres=True)),
        (f"intrabc {FMT_W}x{FMT_H}", synth.inter_sequence(
            FMT_W, FMT_H, 1, intrabc=True)),
    ]
    # the debug mode must reach the ring's worker thread: a sync there fails
    x = torch.ones(1, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with ThreadPoolExecutor(1) as ex:
            ex.submit(x.item).result()
        raise AssertionError("set_sync_debug_mode('error') let a worker "
                             "thread's .item() through")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    def filters_of(label, c, rec, irec):
        """Every recorded filter_ call held to filter_plain, and the
        decode's filter launches to what its frames need; every recorded
        inter program held to inter_plain, one per inter launch."""
        want = filter_want(rec.check(label))
        check_filter_counts(label, {k: c[k] for k in want}, want)
        if irec.check(label) != c["inter"]:
            raise AssertionError(f"{label}: not one inter launch per inter "
                                 "program")

    launches = 0
    inter_counts = None
    for label, packets in streams:
        with FilterRecorder() as rec, InterRecorder() as irec:
            want, fell, c1 = ring_decode(dev, packets, 1)
        filters_of(f"pipeline {label} delay 1", c1, rec, irec)
        inter_counts = inter_counts or c1
        log(f"pipeline {label}: delay 1 fallback frames {fell}, counts "
            + json.dumps(c1))
        for d in (2, 3):
            with FilterRecorder() as rec, InterRecorder() as irec:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got, fell_d, c = ring_decode(dev, packets, d)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            same = got == want and fell_d == fell and c == c1
            log(f"pipeline {label}: delay {d} {'==' if same else '!='} "
                f"delay 1 (MD5s, fallback frames {fell_d}, counts "
                f"{json.dumps(c)}); no host synchronisation on its path")
            if not same:
                raise AssertionError(f"pipeline {label}: delay {d} differs "
                                     "from delay 1")
            filters_of(f"pipeline {label} delay {d}", c, rec, irec)
            launches += c["itx"]
            PIPE["wave"] = PIPE.get("wave", 0) + c["wave"]
            PIPE["inter"] = PIPE.get("inter", 0) + c["inter"]
        PIPE["inter"] = PIPE.get("inter", 0) + c1["inter"]
        if (c1["level"] or c1["class_step"] or c1["plain"]
                or c1["itx"] != len(packets) - len(fell)):
            raise AssertionError(f"pipeline {label}: not one itx launch per "
                                 "engine frame, or a level launch or a "
                                 "plain call")
        if c1["inter_plain"] or not c1["inter"] or c1["inter_earlier"]:
            raise AssertionError(f"pipeline {label}: no inter launch, or an "
                                 "inter_plain call or a launch of the "
                                 "earlier inter form")

    packets = inter * 3
    want = digests["inter"]["md5"] * 3
    walls = {}
    # the last run: delay 2 with the interpreter's switch interval at 0.5
    # ms instead of 5, set here for that run only (how much of the ring's
    # cost is threads waiting for the GIL)
    for d, switch in ((1, None), (2, None), (3, None), (1, None), (2, 5e-4)):
        t = {}
        run.reset_stats()
        old = sys.getswitchinterval()
        if switch:
            sys.setswitchinterval(switch)
        try:
            got, fell, c = ring_decode(dev, packets, d, t)
        finally:
            sys.setswitchinterval(old)
        st = run.stage_ms
        dev_ms = sum(st[k] for k in ("upload", "resid", "inter", "wave",
                                      "filter", "fetch"))
        log(f"pipeline timing delay {d}"
            + (f", switch interval {switch * 1e3} ms" if switch else "")
            + f": {len(got)} frames, wall "
            f"{t['wall']:.1f} ms, {t['wall'] / len(packets):.1f} ms per "
            f"frame; caller's thread: send_data {t['send']:.1f} ms, of it "
            f"the syntax pass {t['syntax']:.1f} ms, get_picture "
            f"{t['get']:.1f} ms; dense passes "
            f"({'the worker busy' if d > 1 else 'inline'}) {t['dense']:.1f} "
            f"ms, of them materialize_work_items {t['work_items']:.1f} ms, "
            f"build_plan {t['plan']:.1f} ms, pack {st['pack']:.1f} ms; "
            f"CUDA-event stages {dev_ms:.3f} ms; stage_ms "
            + json.dumps({k: round(v, 3) for k, v in st.items()}))
        if got != want or fell:
            raise AssertionError(f"pipeline timing delay {d}: MD5s differ "
                                 "from the committed digests or a frame "
                                 "fell back")
        walls.setdefault((d, switch), []).append(t["wall"])
        if d == 1:
            rest = t["wall"] - st["pack"] - dev_ms
            log(f"  delay 1: rest (wall minus the stages) {rest:.1f} ms, of "
                f"it the syntax pass {t['syntax']:.1f} ms "
                f"({100 * t['syntax'] / rest:.1f}%)")
        launches += c["itx"]
        PIPE["wave"] = PIPE.get("wave", 0) + c["wave"]
        PIPE["inter"] = PIPE.get("inter", 0) + c["inter"]
        if c["inter_plain"] or c["inter"] != 3 * inter_counts["inter"]:
            raise AssertionError(f"pipeline timing delay {d}: not three times "
                                 "delay 1's inter launches, or an inter_plain "
                                 "call")
        # the same stream three times over: three times delay 1's filter
        # launches, no plain call
        fc = {k: c[k] for k in filter_want([])}
        check_filter_counts(f"pipeline timing delay {d}", fc, {
            k: 3 * inter_counts[k] for k in fc})
    base = sum(walls[1, None]) / 2
    log("pipeline timing: wall against the mean of the two delay-1 runs: "
        + ", ".join(f"delay {d}{' (0.5 ms switch)' if sw else ''} "
                    f"{100 * w[0] / base:.1f}%"
                    for (d, sw), w in walls.items() if d > 1))
    return launches


def second_card_phase():
    """A decoder on the second card while the first is current: the
    640x360 inter sequence on cuda:1 at delay 1 (the dense pass inline on
    the caller's thread, which enters the decoder's card), decoded as
    dav1d's CLI calls it (ring_decode), must give the host path's MD5s with
    no fallback and its filter launches (filter_want). Run only on a
    machine with two cards or more; returns its itx launches."""
    import torch

    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth

    n = torch.cuda.device_count()
    if n < 2:
        log(f"second card: not run ({n} card on this machine)")
        return 0
    packets = synth.inter_sequence(FMT_W, FMT_H, 3)
    want = synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False),
                                       host_path=True), packets)
    torch.cuda.set_device(0)
    with FilterRecorder() as rec:
        got, fell, c = ring_decode(torch.device("cuda", 1), packets, 1)
        torch.cuda.synchronize(1)
    fwant = filter_want(rec.check("second card"))
    log(f"second card: cuda:1 at delay 1, the current card 0: md5 {got} "
        f"{'==' if got == want else '!='} host path; fallbacks {fell}; "
        f"filter launches {json.dumps({k: c[k] for k in fwant})}")
    if got != want or fell or {k: c[k] for k in fwant} != fwant:
        raise AssertionError("second card: the cuda:1 decode differs from "
                             "the host path or its launches from filter_want")
    return c["itx"]


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
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine import wave as TW
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
        TW.calls = P.inter_plain_calls = 0
        reset_filter_counts()
        dec = T.Decoder(T.Settings(apply_grain=False), device=dev)
        m = hashlib.md5()

        def take():
            try:
                pic = dec.get_picture()
            except T.EAgain:
                return False
            for rows in pic.iter_plane_rows():
                m.update(rows)
            return True

        for pkt in IvfDemuxer(path):
            dec.send_data(pkt.data, pkt.timestamp)
            while take():
                pass
        misses = 0
        while misses < 2:  # the drain handshake
            misses = 0 if take() else misses + 1
        fb = T.engine.stats["fallback"] - before["fallback"]
        plain = filter_counts()["filter_plain"]
        log(f"vector {rel}: md5 {m.hexdigest()} (meson {want}) fallback {fb}"
            f", class_step calls {TW.calls}, plain filter calls {plain}, "
            f"inter_plain calls {P.inter_plain_calls}")
        if m.hexdigest() != want or TW.calls or plain or P.inter_plain_calls:
            raise AssertionError(f"{rel}: md5 mismatch, or class_step, plain "
                                 "filter or inter_plain calls")
    for rel, n in HOST_PATH_VECTORS:
        first_frames_phase(dev, d, rel, n)


def first_frames_phase(dev, d, rel, n):
    """The first n frames of a vector against the port's host path, with
    no fallback, one inter launch per inter frame and no inter_plain call,
    one wave frame launch per frame with wave items, no level launch, no
    class_step call and the frames' filter launches."""
    import rav1d_tpu_torch as T
    from rav1d_tpu_torch import synth
    from rav1d_tpu_torch.engine import programs as P
    from rav1d_tpu_torch.engine import wave as TW
    from rav1d_tpu_torch.engine.pack import pack_frame
    from rav1d_tpu_torch.io.ivf import IvfDemuxer
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import wave as WK

    path = os.path.join(d, rel)
    if not os.path.exists(path):
        log(f"vector phase: {rel} not found; skipped")
        return
    packets = [pkt.data for _, pkt in zip(range(n), IvfDemuxer(path))]
    want = []
    frames = synth.capture_frames(packets, want)
    nframes = wave_frames(frames)
    pks = [(pack_frame(f, plan), int(f.cur.layout))
           for f, plan in frames if plan is not None]
    f_want = filter_want([(pk.hdr, lay, pk.need_sr) for pk, lay in pks])
    before = dict(T.engine.stats)
    TW.calls = WK.launches = WK.level_launches = 0
    IK.launches = IK.earlier_launches = P.inter_plain_calls = 0
    reset_filter_counts()
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device=dev), packets)
    INTER["launches"] += IK.launches
    check_filter_counts(rel, filter_counts(), f_want)
    fb = T.engine.stats["fallback"] - before["fallback"]
    log(f"vector {rel}: {len(got)} frames, "
        f"{sum(a == b for a, b in zip(got, want))} equal to the host path, "
        f"fallback {fb}, class_step calls {TW.calls}, wave frame launches "
        f"{WK.launches} for {nframes} frames, level launches "
        f"{WK.level_launches}, inter launches {IK.launches} for "
        f"{inter_frames(frames)} inter frames, inter_plain calls "
        f"{P.inter_plain_calls}")
    if (got != want or fb or TW.calls or WK.launches != nframes
            or WK.level_launches or P.inter_plain_calls or IK.earlier_launches
            or IK.launches != inter_frames(frames)):
        raise AssertionError(f"{rel}: differs from the host path or fell "
                             f"back ({fb})")


def main():
    import argparse
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--test-data", help="a dav1d-test-data directory for "
                    "the vector phase (skipped without it)")
    ap.add_argument("--only", choices=("uhd",), help="run the set-up and "
                    "this phase alone (its kernels' entries and the last "
                    "line as usual)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on the card")
    import rav1d_tpu_torch  # noqa: F401  (fails outside a checkout)
    from rav1d_tpu_torch.native import BUILD
    from rav1d_tpu_torch.native import syntax as native_syntax
    from rav1d_tpu_torch.ops.cuda import build
    from rav1d_tpu_torch.ops.cuda import filters as FK
    from rav1d_tpu_torch.ops.cuda import inter as IK
    from rav1d_tpu_torch.ops.cuda import itx as I
    from rav1d_tpu_torch.ops.cuda import wave as WK

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
    with ThreadPoolExecutor(7) as ex:  # one nvcc per source, together
        for fut in [ex.submit(I.lib), ex.submit(WK.lib), ex.submit(IK.lib)] + [
                ex.submit(FK.lib, n) for n in ("lf", "cdef", "superres",
                                               "lr")]:
            fut.result()
    log(f"set-up: itx, idct8x8, wave, inter, deblock, CDEF, superres and "
        f"loop restoration kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s; the inter kernel's grid "
        f"{IK.grid()} blocks (the earlier form's {IK.grid(IK.EARLIER)})")
    for name in ("itx", "wave", "inter", "lf", "cdef", "superres", "lr"):
        for ln in build.LOGS.get(name, "").splitlines():  # ptxas -v
            if any(k in ln for k in ("entry function", "Function properties",
                                     "Used", "stack frame")):
                log("  " + ln.replace("ptxas info    :", "").strip())

    if args.only == "uhd":
        uhd_phase(dev)
        imported_check()
        log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
        log(gpu_line())
        log(json.dumps({"kernels": uhd_kernels()}))
        last_line()
        return
    worst = kernel_phase(dev)
    filter_kernel_phase(dev)
    launches, worst_ra, blobs, still = slice_phase(dev)
    worst = max(worst, worst_ra)
    for phase in (inter_phase, high_bitdepth_phase, uhd_phase, formats_phase,
                  headers_phase):
        n, err, *got = phase(dev)
        launches += n
        worst = max(worst, err)
        blobs += got[0] if got else []
    with tempfile.TemporaryDirectory() as tmp:
        n, err = residual_phase(dev, still, tmp)
        launches += n + cli_phase(dev, tmp)
        worst = max(worst, err)
    launches += pipeline_phase(dev)
    launches += second_card_phase()
    WAVE["launches"] += PIPE["wave"]
    INTER["launches"] += PIPE["inter"]
    rows = timing_phase(blobs)
    i8 = idct8x8_phase(dev)
    vector_phase(dev, args.test_data)
    imported_check()

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
    def txt(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    for label, r in WAVE["rows"].items():
        log(f"wave per frame {label} ({r['levels']} levels): frame kernel "
            f"program {r['ms']:.3f} ms, device {txt(r['k_ms'])}; level "
            f"kernel program {r['ms_levels']:.3f} ms, device "
            f"{txt(r['k_levels'])}; barrier-only floor {r['barrier_ms']:.3f}"
            f" ms (device {txt(r['barrier_dev'])}), empty-launch floor "
            f"{r['floor']:.3f} ms; bound {r['bound']:.5f} ms"
            + ("" if r["plain_ms"] is None
               else f", wave_plain {r['plain_ms']:.1f} ms"))
    for label, r in FILT["rows"].items():
        per = "; ".join(
            f"{k} {txt(v['dev_ms'])} device ({v['ev_ms']:.4f} ms alone), "
            f"bound {v['bound']:.5f} ms, plain {txt(v['plain_ms'])}"
            + (f", library {txt(v['library_ms'])}" if "library_ms" in v
               else "")
            for k, v in r["kernels"].items())
        log(f"filter per frame {label}: stage_ms.filter "
            f"{txt(r.get('stage_ms'))} (the decode), filter_ {r['ms']:.3f} ms"
            f", filter_plain {r['plain_ms']:.1f} ms (CUDA events), device "
            f"{txt(r['dev_ms'])}; {per}")
    def txt5(v):
        return "not measured" if v is None else f"{v:.5f} ms"

    for label, rows in FILT["forms"].items():
        log(f"filter forms per frame {label}: " + "; ".join(
            f"{stage} new {txt5(form_ms(r, 'new'))} device, earlier "
            f"{txt5(form_ms(r, 'earlier'))} (the smaller of two readings), "
            f"bound {r['bound']:.5f} ms"
            for stage, r in rows.items()))
    log(f"filter kernels: launches in the decodes {json.dumps(FILT['launches'])}"
        f", {FILT['compared']} frames' filter_ equal to filter_plain; kernel "
        f"phase max |err| {json.dumps(FILT['err'])}; the filter checks and "
        f"timings took {FILT['seconds']:.1f} s of the run")
    log(f"wave kernels: {WAVE['launches']} frame launches in the decodes, "
        f"{WAVE['compared']} frames equal to wave_plain, max |err| "
        f"{WAVE['err']} (frame kernel), {WAVE['err_levels']} (level kernel)")
    for label, r in INTER["rows"].items():
        log(f"inter per frame {label} ({r['tiles']} tiles): stage_ms.inter "
            f"{txt(r.get('stage_ms'))} (the decode), programs.inter "
            f"{r['ms']:.4f} ms (CUDA events; the earlier form "
            f"{r['ms_earlier']:.4f} ms), device inter_batch_kernel "
            f"{txt5(r['k_ms'])}, the earlier inter_frame_kernel "
            f"{txt5(r['k_earlier'])} (the median of four readings); "
            f"inter_plain {r['plain_ms']:.3f} ms, device "
            f"{txt(r['plain_dev'])}; bound {r['bound']:.5f} ms "
            f"({r['bound_by']}); host side {json.dumps(r['host'])}")
    log(f"inter kernel: {INTER['launches']} launches in the decodes, "
        f"{INTER['compared']} engine inter frames equal to inter_plain, max "
        f"|err| {INTER['err']}; on the timed frames new max |err| "
        f"{INTER.get('err_new')}, earlier {INTER.get('err_earlier')}")
    if not INTER["launches"] or not INTER["compared"]:
        raise AssertionError("the inter kernel was not launched in the "
                             "decodes or not compared")
    # the level kernel's own run: its entry over still seed 1's blob, the
    # count reset before and read after (it is on no decoder path now)
    lab, (pk1, d1, ra1, planes1, kw1) = WAVE["still1"]
    WK.level_launches = 0
    levels_program(planes1, ra1, d1, pk1, kw1)
    torch.cuda.synchronize()
    level_launches = WK.level_launches
    if level_launches != WAVE["rows"][lab]["levels"]:
        raise AssertionError("the level kernel's own run: not one launch "
                             "per level")
    # the earlier deblock, CDEF, Wiener and self-guided forms' own run:
    # their entries over still seed 1's filter input, the counts reset
    # before and read after (they are on no decoder path), the result held
    # to the plain stages
    fin1, fd1, fpk1, fkw1 = FILT["still1"]
    _, _, _, _, bh1, bw1, _ = fkw1["geom"]
    k1 = dict(bh=bh1, bw=bw1, layout_i=fkw1["layout_i"], bpc=fkw1["bpc"])
    lr1, lr_want = lr_inputs(fin1, fd1, fpk1, fkw1)
    (w_out, w_src, w_lpf, w_kw), (lr_out, lr_src, lr_lpf, lr_kw) = (
        lr1["wiener"], lr1["sgr"])
    w_want = wiener_plain(w_out, w_src, w_lpf, fd1, fpk1.hdr, **w_kw)
    lrp1 = FK.lr_planes(fpk1.hdr, fkw1["layout_i"])
    n_w, n_sgr = sum(w for _, w, _ in lrp1), sum(s for _, _, s in lrp1)
    FK.lf_lines_launches = FK.cdef_global_launches = 0
    FK.wiener_plane_launches = FK.sgr_plane_launches = 0
    x1 = fin1.clone()
    FK.lf_pass_lines(x1, fd1, fpk1.hdr, False, **k1)
    FK.lf_pass_lines(x1, fd1, fpk1.hdr, True, **k1)
    FK.cdef_frame_global(x1, x1.clone(), fd1, fpk1.hdr, **k1)
    lr_wiener_planes(w_out, w_src, w_lpf, fd1, fpk1.hdr, **w_kw)
    lr_sgr_planes(lr_out, lr_src, lr_lpf, fd1, fpk1.hdr, **lr_kw)
    torch.cuda.synchronize()
    FILT["own"] = dict(lf_lines=FK.lf_lines_launches,
                       cdef_global=FK.cdef_global_launches,
                       wiener_plane=FK.wiener_plane_launches,
                       sgr_plane=FK.sgr_plane_launches)
    if FILT["own"] != dict(lf_lines=2, cdef_global=1, wiener_plane=n_w,
                           sgr_plane=n_sgr) or not (
            torch.equal(x1, plain_stages(fin1, fd1, fpk1, fkw1)["cdef"])
            and torch.equal(w_out, w_want) and torch.equal(lr_out, lr_want)):
        raise AssertionError("the earlier deblock, CDEF, Wiener and "
                             f"self-guided forms' own run: launches "
                             f"{FILT['own']}, or != the plain stages")
    # the earlier inter form's own run: its entry over the 1080p 8-bit
    # inter frame 1, the count reset before and read after, held to
    # inter_plain
    import types

    from rav1d_tpu_torch.engine import programs as P

    f_, plan_, pk_, d_, ra_ = INTER["main_inputs"]
    stacks_, g_ = inter_inputs(f_, plan_, pk_, d_)
    args_ = (ra_, d_, pk_.hdr, pk_.inter_runs) + stacks_
    z_ = torch.zeros((3, plan_.ah, plan_.aw), dtype=torch.int32, device=dev)
    IK.earlier_launches = 0
    got_ = P.inter_kernels(z_.clone(), *args_, **g_, k=types.SimpleNamespace(
        inter_frame=IK.inter_frame_earlier))
    torch.cuda.synchronize()
    INTER["own"] = IK.earlier_launches
    if INTER["own"] != 1 or not torch.equal(got_,
                                            P.inter_plain(z_, *args_, **g_)):
        raise AssertionError("the earlier inter form's own run: "
                             f"{INTER['own']} launches, or != inter_plain")
    kernels = []
    # the itx entry's times and bound: the 8-bit intra pictures' means;
    # the wave entries': still seed 1's wave program through each kernel
    # against wave_plain
    w = WAVE["rows"][lab]
    for name, src, replaces, n_launch, err, ms, pms, nbytes, ops in (
        ("itx", "itx.cu", "rav1d_tpu/ops/pallas/itx_all.py:110", launches,
         worst, *means[8]),
        ("idct8x8", "itx.cu", "rav1d_tpu/ops/pallas/itx8.py:97", *i8),
        ("wave", "wave.cu", "rav1d_tpu/engine/wave2.py:74", level_launches,
         WAVE["err_levels"], w["ms_levels"], w["plain_ms"], w["nbytes"],
         w["ops"]),
        ("rav1d_wave_frame", "wave.cu", "rav1d_tpu/engine/mega.py:213",
         WAVE["launches"], WAVE["err"], w["ms"], w["plain_ms"], w["nbytes"],
         w["ops"]),
    ):
        b_ms, b_by = bound(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes AV1's integer inverse
            # transforms or intra prediction bit-exactly
            "library_ms": None,
        })
    # the filter kernels: still seed 1's frame (the superres kernel: the
    # 1080p superres still's), each kernel's device time (its launches'
    # CUDA-event time where the profiler shows none) against its plain
    # passes
    for key, _, entry, src, replaces in FILTERS:
        k = FILT["rows"][FILT["sr_main"] if key == "sr" else lab][
            "kernels"][key]
        if not FILT["launches"][key]:
            raise AssertionError(f"{entry} was not launched in the decodes")
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": FILT["launches"][key], "max_abs_err": FILT["err"][key],
            "ms": k["ev_ms"] if k["dev_ms"] is None else k["dev_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"],
            "bound_by": k["bound_by"],
            # no single PyTorch call computes AV1's deblock, CDEF or loop
            # restoration bit-exactly; the upscale is one banded matrix
            # product a plane (superres_library)
            "library_ms": k.get("library_ms"),
        })
    # the earlier forms: still seed 1's frame, the stages' device times in
    # filter_forms (their launches' CUDA-event time where the profiler
    # shows none), their own run's launches
    forms = FILT["forms"][lab]
    for key, _, entry, src, replaces in EARLIER:
        stages, new_key = EARLIER_STAGES[key]
        k = FILT["rows"][lab]["kernels"][new_key]
        ms = [form_ms(forms[st], "earlier") for st in stages]
        kernels.append({
            "name": entry, "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/" + src, "replaces": replaces,
            "launches": FILT["own"][key], "max_abs_err": FILT["err"][key],
            "ms": sum(ms) if None not in ms else sum(
                min(forms[st]["ev"]["earlier"]) for st in stages),
            "plain_ms": k["plain_ms"], "bound_ms": k["bound"],
            "bound_by": k["bound_by"], "library_ms": None,
        })
    # the inter kernel and its earlier form: the 1080p 8-bit inter frame
    # 1, each form's device time there (its program's CUDA-event time where
    # the profiler shows none) against inter_plain; the new form's launches
    # in the decodes, the earlier form's in its own run
    r = INTER["rows"][INTER["main"]]
    for name, n_launch, err, ms in (
            ("rav1d_inter_batches", INTER["launches"], INTER["err"],
             r["ms"] if r["k_ms"] is None else r["k_ms"]),
            ("rav1d_inter_frame", INTER["own"], INTER["err_earlier"],
             r["ms_earlier"] if r["k_earlier"] is None else r["k_earlier"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "rav1d_tpu_torch/csrc/inter.cu",
            "replaces": "rav1d_tpu/engine/mega.py:466",
            "launches": n_launch, "max_abs_err": err, "ms": ms,
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"],
            "bound_by": r["bound_by"],
            # no single PyTorch call computes AV1's motion-compensated
            # prediction bit-exactly
            "library_ms": None,
        })
    kernels += uhd_kernels()
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())  # again here, where the end of a long log keeps it
    log(json.dumps({"kernels": kernels}))
    last_line()


def imported_check():
    """Neither JAX nor any module of rav1d_tpu may have been imported."""
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    ref = sorted(m for m in sys.modules
                 if m == "rav1d_tpu" or m.startswith("rav1d_tpu."))
    if ref:
        raise AssertionError(f"modules of rav1d_tpu were imported: {ref}")


def last_line():
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
