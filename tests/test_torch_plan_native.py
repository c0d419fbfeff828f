"""The native key-frame planner (csrc/host/plan.c, native/plan.py) against
its twin, the Python planner of engine/plan.py, and its dispatch.

Parity: each key frame of seeded synthetic streams is planned twice, first
from its pending block records by the C planner, then from its WorkItems
by the Python planner. The C planner's wave rows must equal what
engine/pack.py _pack_class writes from the Python items, its palette
scatter what _pack_palette builds from plan.pal, its wave count and
wavefront_tx the Python plan's; and pack_frame's header and every blob part
must be byte-identical. The cases cover 8, 10 and 12 bits, 4:0:0, 4:2:0,
4:2:2 and 4:4:4, synth.Tools (128-px superblocks, 2x2 tiles, segmentation
with its lossless WHT segment, delta q, TX_MODE_LARGEST), superres and a
1080p still; palette, CfL and filter intra occur among them.

Dispatch, on the CPU engine: every key frame and no inter frame is planned
natively (engine.stats["plan_native"]), with no WorkItem built; the output
is the host path's; without the library the Python planner plans and the
output is the same; a frame that uses intra block copy is gated to the host
path and counted as a fallback.
"""

import functools

import numpy as np
import pytest

import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.decoder import Decoder, Settings
from rav1d_tpu_torch.engine import plan as PL
from rav1d_tpu_torch.engine.layout import N_FIELDS
from rav1d_tpu_torch.engine.pack import _pack_class, pack_frame
from rav1d_tpu_torch.headers import PixelLayout as PLY
from rav1d_tpu_torch.native import plan as NP
from rav1d_tpu_torch.recon import frame as RF
from rav1d_tpu_torch.syntax.levels import FILTER_PRED, Z1_PRED, Z3_PRED

pytestmark = pytest.mark.skipif(NP.lib() is None,
                                reason="no C compiler for the planner")

Tools = synth.Tools
CASES = {
    "8bit-420": lambda: [synth.still_picture(200, 120, 0)],
    "8bit-400": lambda: [synth.still_picture(160, 96, 1, layout=PLY.I400)],
    "10bit-420": lambda: [synth.still_picture(160, 96, 2, bpc=10)],
    "12bit-422": lambda: [synth.still_picture(160, 96, 3, bpc=12,
                                              layout=PLY.I422)],
    "8bit-444": lambda: [synth.still_picture(160, 96, 4, layout=PLY.I444)],
    "10bit-444": lambda: [synth.still_picture(160, 96, 5, bpc=10,
                                              layout=PLY.I444)],
    "12bit-400": lambda: [synth.still_picture(160, 96, 6, bpc=12,
                                              layout=PLY.I400)],
    "8bit-422": lambda: [synth.still_picture(160, 96, 7, layout=PLY.I422)],
    "superres": lambda: [synth.still_picture(200, 120, 8, superres=True)],
    "sb128": lambda: [synth.still_picture(256, 160, 9,
                                          tools=Tools(sb128=True))],
    "tiles2x2": lambda: [synth.still_picture(256, 160, 10,
                                             tools=Tools(tiles=(1, 1)))],
    "segmentation": lambda: [synth.still_picture(
        256, 160, 11, tools=Tools(segmentation=True))],
    "delta_q": lambda: [synth.still_picture(256, 160, 12,
                                            tools=Tools(delta_q=True))],
    "tx_mode_largest": lambda: [synth.still_picture(
        256, 160, 13, tools=Tools(tx_mode_largest=True))],
    "640x360": lambda: [synth.still_picture(640, 360, 5)],
    "seq-12bit-420": lambda: synth.inter_sequence(200, 120, 2, bpc=12),
    "1080p": lambda: [synth.still_picture(1920, 1080, 1)],
}


@functools.lru_cache(maxsize=None)
def planned(name):
    """[(f, native plan, Python plan)] for each key frame of the case's
    stream: its records planned by the C planner, then its WorkItems by the
    Python planner. No dense pass runs (the planners read no pixel)."""
    got = []

    class _Plan(Decoder):
        def _decode_dense(self, f):
            if not f.frame_hdr.frame_type.is_key_or_intra:
                return
            t = f._dense_args[0]
            assert f._wi_pending and not f.work_items
            nat = PL.build_plan(t, f)
            RF.materialize_work_items(f)
            got.append((f, nat, PL.build_plan(t, f)))

    synth.decode_md5s(_Plan(Settings(apply_grain=False), host_path=True),
                      CASES[name]())
    assert got
    return got


def _python_rows(plan):
    psz = plan.ah * plan.aw
    nw = max(plan.n_waves, 1)
    return [_pack_class([(it, plan.aw) for it in plan.items
                         if PL.item_class(it.w, it.h) == c], nw, PL.CAP[c],
                        psz) for c in (0, 1)]


def _python_scatter(plan):
    psz = plan.ah * plan.aw
    idx, val = [np.zeros(0, np.int32)], [np.zeros(0, np.int32)]
    for pl, y, x, pix in plan.pal:
        h, w = pix.shape
        ii = (pl * psz + y * plan.aw + x + np.arange(h)[:, None] * plan.aw
              + np.arange(w)[None, :])
        idx.append(ii.ravel().astype(np.int32))
        val.append(pix.ravel().astype(np.int32))
    return np.concatenate(idx), np.concatenate(val)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_plan_equals_python_plan(name):
    for f, nat, py in planned(name):
        assert py is not None and nat is not None
        assert nat.native is not None and not nat.items and not nat.pal
        assert py.native is None
        assert nat.n_waves == py.n_waves
        assert nat.native.n_items == len(py.items)
        rows = _python_rows(py)
        for c in (0, 1):
            assert nat.native.rows[c].shape == (max(py.n_waves, 1),
                                               PL.CAP[c], N_FIELDS)
            np.testing.assert_array_equal(nat.native.rows[c], rows[c])
        idx, val = _python_scatter(py)
        np.testing.assert_array_equal(nat.native.pal_idx, idx)
        np.testing.assert_array_equal(nat.native.pal_val, val)
        np.testing.assert_array_equal(nat.wavefront_tx, py.wavefront_tx)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_plan_packs_the_same_blob(name):
    for f, nat, py in planned(name):
        a, b = pack_frame(f, nat), pack_frame(f, py)
        assert a.hdr.tobytes() == b.hdr.tobytes()
        assert [o for o, _ in a.blob.parts] == [o for o, _ in b.blob.parts]
        for (_, x), (_, y) in zip(a.blob.parts, b.blob.parts):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        assert a.blob.zparts == b.blob.zparts
        assert a.words().tobytes() == b.words().tobytes()
        assert a.tx_valid == b.tx_valid
        assert len(a.waves) == len(b.waves)
        for wa, wb in zip(a.waves, b.waves):
            for (ra, na, fa, ma), (rb, nb, fb, mb) in zip(wa, wb):
                assert (na, fa, ma) == (nb, fb, mb)
                np.testing.assert_array_equal(ra, rb)


def test_cases_use_palette_cfl_and_filter_intra():
    """The parity cases exercise every intra tool the planner treats apart:
    palette pixels and palette residual items, CfL, filter intra, the
    directional modes, skipped and coded transform blocks."""
    seen = dict(palette=0, ident=0, cfl=0, filter=0, directional=0,
                coded=0, uncoded=0)
    for name in CASES:
        for f, nat, py in planned(name):
            seen["palette"] += len(py.pal)
            for it in py.items:
                seen["ident"] += it.mode == PL.MODE_IDENT
                seen["cfl"] += it.mode >= PL.MODE_CFL_DC
                seen["filter"] += it.mode == FILTER_PRED
                seen["directional"] += Z1_PRED <= it.mode <= Z3_PRED
                seen["coded" if it.tx >= 0 else "uncoded"] += 1
    assert all(seen.values()), seen


def test_bad_records_raise(monkeypatch):
    """A record range past the record array is refused, not read."""
    (f, _, _), = planned("8bit-420")
    monkeypatch.setattr(f, "_wi_pending", [(0, 0, f._sy_rec.size + 1, None)])
    with pytest.raises(RuntimeError):
        NP.plan_frame(f, 8, 8, PL.CAP, N_FIELDS)


# ------------------------------- dispatch --------------------------------

SEQ = functools.partial(synth.inter_sequence, 200, 120, 0)


def _host(packets):
    return synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), packets)


def _engine(packets, monkeypatch):
    """Engine MD5s, the engine.stats deltas, and the frame types of the
    frames whose records became WorkItems."""
    materialized = []
    real = RF.materialize_work_items

    def spy(f):
        if f._wi_pending:
            materialized.append(int(f.frame_hdr.frame_type))
        return real(f)

    before = dict(T.engine.stats)
    with monkeypatch.context() as m:
        m.setattr(RF, "materialize_work_items", spy)
        md5 = synth.decode_md5s(
            T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    return md5, {k: T.engine.stats[k] - before[k] for k in before}, \
        materialized


def test_key_frames_plan_natively(monkeypatch):
    packets = SEQ()
    md5, stats, materialized = _engine(packets, monkeypatch)
    assert md5 == _host(packets) and len(md5) == 3
    assert stats == dict(frames=3, fallback=0, ref_uploads=0, plan_native=1)
    # the key frame (type 0) never became WorkItems; both inter frames did
    assert materialized == [1, 1]


def test_without_the_library_python_plans(monkeypatch):
    packets = SEQ()
    monkeypatch.setattr(NP, "lib", lambda: None)
    calls = []
    real = NP.plan_frame
    monkeypatch.setattr(NP, "plan_frame",
                        lambda *a: calls.append(1) or real(*a))
    md5, stats, materialized = _engine(packets, monkeypatch)
    assert md5 == _host(packets)
    assert stats == dict(frames=3, fallback=0, ref_uploads=0, plan_native=0)
    assert materialized == [0, 1, 1] and not calls


def test_gated_frame_takes_the_host_path(monkeypatch):
    """A key frame that uses intra block copy: the C planner gates it, the
    frame's records become WorkItems and it decodes on the host path."""
    packets = synth.inter_sequence(200, 120, 1, intrabc=True)
    statuses = []
    real = NP.plan_frame

    def spy(*a):
        out = real(*a)
        statuses.append(out[0])
        return out

    monkeypatch.setattr(NP, "plan_frame", spy)
    md5, stats, materialized = _engine(packets, monkeypatch)
    assert md5 == _host(packets)
    assert statuses == [NP.PLAN_GATE]
    assert stats == dict(frames=3, fallback=1, ref_uploads=3, plan_native=0)
    assert materialized == [0, 1, 1]
