"""Header tools that the default synthetic streams never write, decoded by
rav1d_tpu_torch on the CPU.

synth.Tools turns on, one at a time and all together: 128-px superblocks,
2x2 tiles, segmentation (8 segments with their own q and filter levels,
one of them lossless, so the frame blob carries WHT blocks), delta q with
delta lf (multi off and on), loop filter deltas per reference and mode,
TX_MODE_LARGEST with the reduced transform set, and 64-px restoration
units (the 96-px luma stripe bucket of the LR packer). Each tool decodes
in an 8-bit still picture and in 8- and 10-bit 4:2:0 sequences (a key
frame and two inter frames). Every frame must decode on the engine
(Decoder(device="cpu")) to the MD5 of the port's host path, with no
fallback, and the port's host path must equal rav1d_tpu's on the same
bytes, which shows that both packages parse the new header bytes alike.

rav1d_tpu's host path runs here with one thread (Settings(n_threads=1)).
Its C syntax pass decodes the tiles of a frame on parallel threads, and
two scratch buffers of that pass were static (record_lf_inter's
transform-split map and read_pal_indices' colour order), so parallel
tiles overwrote each other's: deblock edge classes that change from run
to run on multi-tile inter frames, and now and then a tile that never
ends. The port's copy (csrc/host/syntax.c) keeps both on the stack;
test_tile_parallel_syntax_is_deterministic holds it to the serial pass.

Tolerance: exact.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

import rav1d_tpu
import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.headers import TxfmMode
from rav1d_tpu_torch.synth import Tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = dict(segmentation=True, delta_q=True, lf_deltas=True,
           tx_mode_largest=True, tiles=(1, 1))
# name: (tools, width, height); 128-px superblocks at 384x256 (3x2
# superblocks, so 2x2 tiles), the rest at 320x192
CASES = {
    "segmentation": (Tools(segmentation=True), 320, 192),
    "delta-q-lf": (Tools(delta_q=True), 320, 192),
    "delta-lf-multi": (Tools(delta_q=True, delta_lf_multi=True), 320, 192),
    "lf-deltas": (Tools(lf_deltas=True), 320, 192),
    "sb128": (Tools(sb128=True), 384, 256),
    "tiles-2x2": (Tools(tiles=(1, 1)), 320, 192),
    "tx-largest-reduced": (Tools(tx_mode_largest=True), 320, 192),
    "lr-64": (Tools(lr_unit_shift=0), 320, 192),
    # all together: with 128-px superblocks (LR units then 256 px), and
    # with 64-px superblocks and 64-px LR units
    "all-sb128": (Tools(sb128=True, delta_lf_multi=True, **ALL), 384, 256),
    "all-lr-64": (Tools(lr_unit_shift=0, **ALL), 320, 192),
}
KINDS = ("still-8bit", "inter-8bit", "inter-10bit")


def packets_of(name, kind):
    tools, w, h = CASES[name]
    if kind == "still-8bit":
        return [synth.still_picture(w, h, 3, tools=tools)]
    if kind == "inter-8bit":
        return synth.inter_sequence(w, h, 3, tools=tools)
    return synth.inter_sequence(w, h, 4, bpc=10, tools=tools)


def engine_md5s(packets):
    """Per frame: (MD5 on the engine, frames it sent to the host path)."""
    dec = T.Decoder(T.Settings(apply_grain=False), device="cpu")
    out = []
    for data in packets:
        fb = T.engine.stats["fallback"]
        out += [(m, T.engine.stats["fallback"] - fb)
                for m in synth.decode_md5s(dec, [data])]
    return out


def reference_md5s(packets):
    return synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False,
                                             n_threads=1)),
        packets, eagain=rav1d_tpu.EAgain)


def check_tools(name, frames):
    """The header fields and frame content each tool must give, so that a
    case which decodes is not a case that wrote nothing new."""
    tools = CASES[name][0]
    packs = [pack_frame(f, plan) for f, plan in frames]
    for f, _ in frames:
        hdr = f.frame_hdr
        assert f.seq_hdr.sb128 == int(tools.sb128)
        assert (hdr.tiling.cols, hdr.tiling.rows) == (
            (2, 2) if tools.tiles == (1, 1) else (1, 1))
        assert hdr.segmentation.enabled == int(tools.segmentation)
        if tools.segmentation:
            assert sum(hdr.segmentation.lossless) == 1
        assert hdr.delta.q.present == int(tools.delta_q)
        assert hdr.delta.lf.present == int(tools.delta_q)
        assert hdr.delta.lf.multi == int(tools.delta_lf_multi)
        assert hdr.loopfilter.mode_ref_delta_enabled == int(tools.lf_deltas)
        assert hdr.txfm_mode == (TxfmMode.LARGEST if tools.tx_mode_largest
                                 else TxfmMode.SWITCHABLE)
        assert hdr.reduced_txtp_set == int(tools.tx_mode_largest)
    if tools.segmentation and len(frames) > 1:
        # the lossless segment's blocks, in a sequence's three frames (one
        # picture's random segment ids need not pick that segment)
        assert sum(p.tx_valid.get("wht", 0) for p in packs) > 0
    if tools.lr_unit_shift == 0 and not tools.sb128:
        assert all(p.lr_ws[0] == 96 for p in packs)  # luma stripe bucket
    else:
        assert all(p.lr_ws[0] == 384 for p in packs)
    if tools.delta_q or tools.segmentation or (tools.lf_deltas
                                               and len(frames) > 1):
        # luma filter levels vary across a frame (per superblock, segment,
        # reference or mode), not one level per plane
        levels = [f.lf_level[..., 0] for f, _ in frames]
        assert max(np.unique(lv[lv > 0]).size for lv in levels) >= 2


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_tools_decode_on_engine(name, kind):
    packets = packets_of(name, kind)
    host = []
    frames = synth.capture_frames(packets, host)
    assert len(host) == len(packets)
    assert all(plan is not None for _, plan in frames)  # no planner gate
    check_tools(name, frames)
    assert engine_md5s(packets) == [(m, 0) for m in host]
    assert reference_md5s(packets) == host


def test_default_tools_leave_the_bytes_unchanged():
    """Tools() writes what the writers wrote before it existed (SHA-256 of
    those bytes)."""
    still = synth.still_picture(120, 72, 1)
    inter = synth.inter_sequence(136, 96, 2)
    assert still == synth.still_picture(120, 72, 1, tools=Tools())
    assert inter == synth.inter_sequence(136, 96, 2, tools=Tools())
    assert hashlib.sha256(still).hexdigest() == (
        "f06d76514e8405dd5858af6d6571b843b480ce7c4df7258af8a412922db1fc55")
    assert hashlib.sha256(b"".join(inter)).hexdigest() == (
        "f923f4d7b8ad73264b03b1050b5555b5cc3d406a68c5e0779d40b27b884a2871")


def test_tile_parallel_syntax_is_deterministic():
    """The port's host path on 2x2-tile sequences (key frame with palette,
    inter frames) with four syntax threads, five times over, equals its
    serial pass. Run in a child process with a time limit: with the static
    scratch buffers, the decode differed from run to run, or hung."""
    code = (
        "import rav1d_tpu_torch as T\n"
        "from rav1d_tpu_torch import synth\n"
        "from rav1d_tpu_torch.synth import Tools\n"
        "for bpc, seed in ((10, 4), (8, 3)):\n"
        "    pk = synth.inter_sequence(320, 192, seed, bpc=bpc,\n"
        "                              tools=Tools(tiles=(1, 1)))\n"
        "    def md5s(n):\n"
        "        return synth.decode_md5s(T.Decoder(T.Settings(\n"
        "            apply_grain=False, n_threads=n), host_path=True), pk)\n"
        "    want = md5s(1)\n"
        "    for _ in range(5):\n"
        "        got = md5s(4)\n"
        "        assert got == want, (bpc, got, want)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
