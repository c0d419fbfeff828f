"""The port's inter phase against the JAX engine's, on the CPU.

Seeded synthetic inter sequences (rav1d_tpu_torch/synth.py inter_sequence:
a key frame, then two inter frames with every inter tool 4:2:0 reaches),
all at one geometry so that mega.inter_prog compiles once. Each package
decodes the same bytes through its own front end on its host path, and for
each inter frame:

1. the port's packer (pack_frame, with _plan_inter_v3) writes a blob
   word-identical to run2's, and both name the same reference pictures
   and planes in the same order;
2. programs.inter equals mega.inter_prog on the two packages' blobs, each
   package's stack of those reference planes, and the same residual
   buffer (the port's resid_plain, which test_torch_programs.py holds to
   resid_prog);
3. per slot group: both blobs keep only that group's chunk counts in their
   header words (counts are data, so JAX does not recompile), and the two
   programs must still agree, so a mismatch names its slots;
4. the frames carry work in every slot of mega.py SLOTS except segy00 and
   segy10 (4:2:2 and 4:4:4 only), every put and prep filter case, and
   interintra wave items; no frame comes near a pool's capacity;
5. programs.wave equals mega.wave_prog on an inter frame's blob, whose
   interintra items take the wave step's mask-blend branch.

Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.engine import mega as JM
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import layout as L
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.engine.run import stack_planes
from test_torch_pack import ref_capture, run2_pack, run2_words

W, H = 256, 192  # one geometry: mega.inter_prog compiles once
SEEDS = (1, 2)
CASES = [(s, i) for s in SEEDS for i in (1, 2)]  # (seed, inter frame)

_SEQ = {}


def _sequence(seed):
    """Both packages' captures of inter_sequence(W, H, seed), cached."""
    if seed not in _SEQ:
        packets = synth.inter_sequence(W, H, seed)
        _SEQ[seed] = (synth.capture_frames(packets), ref_capture(packets))
    return _SEQ[seed]


def _jax_stack(srcs, pad_to):
    """run2._stack over the reference pictures' host planes: padded to
    pad_to rows with copies of the first, as the JAX engine keeps its
    compile key fixed."""
    rows = [np.asarray((pic.y, pic.u, pic.v)[pl]) for pic, pl in srcs]
    rows += [rows[0]] * (pad_to - len(rows))
    return jnp.asarray(np.stack(rows[:pad_to]))


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: "s%d-frame%d" % c)
def frame(request):
    """(port frame, plan, FramePack, port blob, JAX blob, JAX stacks,
    the residual buffer) of one inter frame."""
    seed, i = request.param
    port, ref = _sequence(seed)
    (f, plan), (rf, rplan) = port[i], ref[i]
    assert plan.inter is not None and rplan.inter is not None
    pk = pack_frame(f, plan)
    psz = plan.ah * plan.aw
    dev, cap = Uploader("cpu").upload(pk, psz, 8)
    hdr, blob, _, srcs = run2_pack(rf, rplan)
    words = run2_words(hdr, blob)
    np.testing.assert_array_equal(pk.words(), words)
    ref_words = np.zeros(cap, np.int32)
    ref_words[: words.size] = words
    stacks = (_jax_stack(srcs[0], 8), _jax_stack(srcs[1], 16))
    ra, _ = P.resid_plain(dev, pk.hdr, pk.tx_valid, ah=plan.ah, aw=plan.aw,
                          bpc=8)
    return f, plan, pk, dev, jnp.asarray(ref_words), srcs, stacks, ra


def _geometry(f):
    return dict(ah=f.cur.y.shape[0], aw=f.cur.y.shape[1], bpc=8,
                vwY=f.cur.w, vhY=f.cur.h, vwC=(f.cur.w + 1) >> 1,
                vhC=(f.cur.h + 1) >> 1)


def _run_both(frame, slots=None):
    """(port planes, JAX planes) of the inter phase; with `slots`, both
    blobs keep only those slots' chunk counts."""
    f, plan, pk, dev, devj, _, (sY, sC), ra = frame
    g = _geometry(f)
    hdr, runs = pk.hdr, pk.inter_runs
    if slots is not None:
        hdr = hdr.copy()
        dev = dev.clone()
        for name, k in L.SLOTS.items():
            if name not in slots:
                w = L.INTER0 + 2 * k + 1
                hdr[w] = 0
                dev[w] = 0
                devj = devj.at[w].set(0)
        runs = {k: v for k, v in runs.items() if k in slots}
    zeros = torch.zeros((3, g["ah"], g["aw"]), dtype=torch.int32)
    stackY = stack_planes(pk.srcs[0], "cpu", (g["ah"], g["aw"]))
    stackC = stack_planes(pk.srcs[1], "cpu", f.cur.u.shape)
    got = P.inter(zeros, ra, dev, hdr, runs, stackY, stackC, **g)
    want = JM.inter_prog(jnp.zeros((3, g["ah"], g["aw"]), jnp.int32),
                         jnp.asarray(ra.numpy()), devj, sY, sC, **g)
    return got.numpy(), np.asarray(want)


def test_blob_and_sources_match_run2(frame):
    f, plan, pk, dev, devj, srcs, _, _ = frame
    np.testing.assert_array_equal(dev.numpy(), np.asarray(devj))
    for ours, theirs in zip(pk.srcs, srcs):
        assert len(ours) == len(theirs) > 0
        for (pic, pl), (rpic, rpl) in zip(ours, theirs):
            assert pl == rpl
            assert pic.frame_hdr.frame_offset == rpic.frame_hdr.frame_offset
            np.testing.assert_array_equal((pic.y, pic.u, pic.v)[pl],
                                          (rpic.y, rpic.u, rpic.v)[rpl])


def test_inter_matches_inter_prog(frame):
    got, want = _run_both(frame)
    np.testing.assert_array_equal(got, want)
    assert want.any()


GROUPS = {
    "put": ("putY", "putC"),
    "warp": ("warpY", "warpC"),
    "avg": ("prepY", "prepC", "wprepY", "wprepC", "hostpool", "avg"),
    "mask": ("prepY", "prepC", "wprepY", "wprepC", "hostpool", "mask"),
    "seg": ("prepY", "prepC", "wprepY", "wprepC", "hostpool", "segy00",
            "segy10", "segy11", "seguv"),
    "obmc": ("putY", "putC", "lapY", "lapC", "blend"),
    "resid": (),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_inter_per_slot_group(frame, group):
    got, want = _run_both(frame, set(GROUPS[group]))
    np.testing.assert_array_equal(got, want)


def test_every_slot_carries_work():
    """Every slot but segy00/segy10 has tiles on some test frame, every
    put case (0-4) and prep case (0-3) runs, interintra items exist, and
    no frame comes near the pool capacity of either program."""
    tiles = dict.fromkeys(L.SLOTS, 0)
    put_cases, prep_cases = set(), set()
    ii = 0
    for seed in SEEDS:
        for f, plan in _sequence(seed)[0][1:]:
            ft = synth.features(f, plan)
            for k, v in ft["inter_tiles"].items():
                tiles[k] += v
            ii += ft["ii_items"]
            jax_cap = (6 * plan.ah * plan.aw) // 64
            assert ft["pool_cap"] == (8 * plan.ah * plan.aw) // 64
            assert ft["pool_rows"] < jax_cap // 2, ft
            assert ft["lap_rows"] < jax_cap // 2, ft
            runs = pack_frame(f, plan).inter_runs
            for name in ("putY", "putC", "lapY", "lapC"):
                put_cases |= {r.case for r in runs.get(name, ())}
            for name in ("prepY", "prepC"):
                prep_cases |= {r.case for r in runs.get(name, ())}
    empty = [k for k, v in tiles.items() if not v]
    assert sorted(empty) == ["segy00", "segy10"], tiles
    assert put_cases == {0, 1, 2, 3, 4}, put_cases
    assert prep_cases == {0, 1, 2, 3}, prep_cases
    assert ii > 0


def test_wave_on_inter_frame():
    """The wave program on an inter frame with interintra items (their
    F_II mask blend) against wave_prog, both from the JAX inter output."""
    seed, i = CASES[0]
    port, ref = _sequence(seed)
    (f, plan), (rf, rplan) = port[i], ref[i]
    assert any(it.iioff >= 0 for it in plan.items)
    pk = pack_frame(f, plan)
    psz = plan.ah * plan.aw
    dev, cap = Uploader("cpu").upload(pk, psz, 8)
    hdr, blob, _, srcs = run2_pack(rf, rplan)
    words = np.zeros(cap, np.int32)
    words[: blob.pos] = run2_words(hdr, blob)
    devj = jnp.asarray(words)
    g = _geometry(f)
    ra, _ = P.resid_plain(dev, pk.hdr, pk.tx_valid, ah=g["ah"], aw=g["aw"],
                          bpc=8)
    raj = jnp.asarray(ra.numpy())
    pre = JM.inter_prog(jnp.zeros((3, g["ah"], g["aw"]), jnp.int32), raj,
                        devj, _jax_stack(srcs[0], 8), _jax_stack(srcs[1], 16),
                        **g)
    pre_np = np.array(pre)
    want = JM.wave_prog(pre, raj, devj, ah=g["ah"], aw=g["aw"], bpc=8,
                        ss_hor=1, ss_ver=1)
    got = P.wave(torch.from_numpy(pre_np), ra, dev, pk.hdr, pk.waves,
                 ah=g["ah"], aw=g["aw"], bpc=8, ss_hor=1, ss_ver=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
