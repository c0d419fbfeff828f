"""The port's layout constants and numpy packers against the JAX engine's.

- every constant of rav1d_tpu_torch/engine/layout.py equals its original
  in rav1d_tpu/engine/mega.py, tiles.py, wave2.py and kernels.py;
- pack_frame, on a frame decoded by the port's own front end, writes a
  header and blob word-identical to run2's packers on the same bytes'
  frame decoded by rav1d_tpu's front end;
- the device blob is the used prefix zero-padded to run2's capacity;
- importing rav1d_tpu_torch and decoding a picture on the CPU never
  imports JAX or rav1d_tpu (a fresh subprocess).

`ref_capture` and `run2_pack` (the reference's side of that comparison)
are also used by tests/test_torch_programs.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rav1d_tpu
from rav1d_tpu.engine import kernels as JK
from rav1d_tpu.engine import mega as JM
from rav1d_tpu.engine import run2 as J2
from rav1d_tpu.engine import wave2 as JW
from rav1d_tpu.engine.blob2 import FrameBlob as RefFrameBlob
from rav1d_tpu.engine.blob2 import bucket_pow2
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import layout as L
from rav1d_tpu_torch.engine.blob import FrameBlob, Uploader, det_cap_words
from rav1d_tpu_torch.engine.pack import pack_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = ["HDR_LEN", "SIZES", "R0", "WHT0", "CF0", "PAL0", "WAVE0", "INTER0",
         "N_SLOTS", "IH0", "DB0", "CDEF0", "SR0", "LR0", "PAL_B", "LRB",
         "WHT_B", "SLOTS", "TB", "NPUT", "NWARP", "NCOMB", "NBLEND", "HB"]

# the inter tile descriptor rows, which mega.py imports from tiles.py
ROWS = ["D_SROW", "D_SY", "D_SX", "D_MX", "D_MY", "D_F2D", "D_FLAT0", "D_TW",
        "D_TH", "D_BW", "D_BH", "W_SROW", "W_SY", "W_SX", "W_A", "W_B", "W_C",
        "W_D", "W_MX", "W_MY", "W_FLAT0", "W_TW", "W_TH", "C_R0", "C_R1",
        "C_FLAT0", "C_P0", "C_P1", "C_P2", "C_TW", "C_TH", "B_ROW", "B_FLAT0",
        "B_MOFF", "B_MRS", "B_MCS", "B_TW", "B_TH"]


@pytest.mark.parametrize("name", NAMES)
def test_header_layout_matches_mega(name):
    assert getattr(L, name) == getattr(JM, name)


@pytest.mark.parametrize("name", ROWS)
def test_tile_rows_match_tiles(name):
    from rav1d_tpu.engine import tiles as JT

    assert getattr(L, name) == getattr(JT, name) == getattr(JM, name)


def test_wave_and_itx_constants_match():
    assert L.FIELDS == JW.FIELDS and L.N_FIELDS == JW.N_FIELDS
    for k in ("F_Z", "F_FILTER", "F_CFL", "F_IDENT", "F_II"):
        assert getattr(L, k) == getattr(JW, k)
    assert L.VARIANTS == JK.VARIANTS
    np.testing.assert_array_equal(L.TXTP_FIRST, JK.TXTP_FIRST)
    np.testing.assert_array_equal(L.TXTP_SECOND, JK.TXTP_SECOND)
    for w, h in L.SIZES:
        assert L.chunk_for(w, h) == JK.chunk_for(w, h)
        assert L.variants_for(w) == JK._variants_for(w)


class _RefCapture(rav1d_tpu.Decoder):
    """rav1d_tpu's decoder on its host path, keeping each frame's context
    and plan as its dense pass starts. It enters through the decoder's own
    frame-ring hook (_submit_dense), run inline, so nothing of rav1d_tpu is
    patched."""

    def __init__(self):
        super().__init__(rav1d_tpu.Settings(apply_grain=False))
        self.got = []

    def _frame_delay(self):
        return 2

    def _submit_dense(self, f):
        from rav1d_tpu.engine.plan import build_plan
        from rav1d_tpu.recon.frame import (
            decode_frame_dense, materialize_work_items,
        )

        materialize_work_items(f)
        self.got.append((f, build_plan(f._dense_args[0], f)))
        decode_frame_dense(f)


def ref_capture(packets):
    """[(f, plan)] of each frame, from rav1d_tpu's own front end."""
    dec = _RefCapture()
    synth.decode_md5s(dec, packets, eagain=rav1d_tpu.EAgain)
    return dec.got


def run2_pack(f, plan):
    """run2.execute's packing half on a rav1d_tpu frame: (hdr, blob,
    lr_ws, srcs), srcs the inter packer's (srcsY, srcsC) (None on an
    intra frame)."""
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    store = f.coef_store
    hdr = np.zeros(J2.HDR_LEN, np.int32)
    blob = RefFrameBlob(J2.HDR_LEN)
    if store.tx_pos:
        cf = store.cf[: store.cf_pos]
        hdr[J2.CF0] = (blob.add_i16(cf) if f.cur.bpc == 8
                       else blob.add_words(cf))
    J2._pack_residuals(blob, hdr, store, plan, psz, aw)
    srcs = None
    if plan.inter is not None:
        srcs = J2._plan_inter_v3(f, plan, blob, hdr, psz, aw)
        assert srcs is not None, "the inter pools would overflow"
    J2._pack_palette(blob, hdr, plan, psz, aw)
    J2._pack_wave(blob, hdr, plan, psz, aw)
    J2._pack_deblock(f, blob, hdr)
    J2._pack_cdef(f, blob, hdr)
    if f.frame_hdr.size.width[0] != f.frame_hdr.size.width[1]:
        for ci in range(2):
            hdr[J2.SR0 + 2 * ci] = f.resize_step[ci]
            hdr[J2.SR0 + 2 * ci + 1] = f.resize_start[ci]
    lr_ws = J2._pack_lr(f, blob, hdr)
    return hdr, blob, lr_ws, srcs


def run2_words(hdr, blob):
    buf = np.zeros(blob.pos, np.int32)
    buf[: hdr.size] = hdr
    for off, a in blob.parts:
        buf[off : off + a.size] = a
    return buf


@pytest.mark.parametrize("w,h,seed", [(136, 96, 10), (120, 72, 6), (72, 136, 1)])
def test_pack_matches_run2(w, h, seed):
    packets = [synth.still_picture(w, h, seed)]
    (f, plan), = synth.capture_frames(packets)
    (rf, rplan), = ref_capture(packets)
    hdr, blob, lr_ws, _ = run2_pack(rf, rplan)
    pk = pack_frame(f, plan)
    np.testing.assert_array_equal(pk.hdr, hdr)
    assert pk.blob.pos == blob.pos
    assert pk.lr_ws == lr_ws
    np.testing.assert_array_equal(pk.words(), run2_words(hdr, blob))
    # the host counts agree with the blob's own
    assert len(pk.waves) == max(plan.n_waves, 1) if plan.items else not pk.waves
    n_items = sum(n for per in pk.waves for _, n, _, _ in per)
    assert n_items == len(plan.items)

    psz = plan.ah * plan.aw
    dev, cap = Uploader("cpu").upload(pk, psz, 8)
    for bpc in (8, 10, 12):  # word coefficients above 8 bits: twice the cap
        assert det_cap_words(psz, bpc) == J2.det_cap_words(psz, bpc)
    assert cap == bucket_pow2(max(blob.pos, hdr.size, J2.det_cap_words(psz, 8)))
    got = dev.numpy()
    np.testing.assert_array_equal(got[: blob.pos], pk.words())
    assert not got[blob.pos :].any()


def test_partial_last_chunk_lanes():
    """tx_valid counts exactly the filled lanes; the rest are padding."""
    (f, plan), = synth.capture_frames([synth.still_picture(136, 96, 10)])
    pk = pack_frame(f, plan)
    store = f.coef_store
    sel = np.arange(store.tx_pos)
    sel = sel[store.eob[sel] >= 0]
    assert sum(pk.tx_valid.values()) == sel.size
    for si, (w, h) in enumerate(L.SIZES):
        nc = int(pk.hdr[L.R0 + 2 * si + 1])
        if nc:
            B = L.chunk_for(w, h)
            assert 0 < pk.tx_valid[si] <= nc * B
            assert pk.tx_valid[si] > (nc - 1) * B


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import rav1d_tpu_torch as T\n"
        "from rav1d_tpu_torch import synth\n"
        "md5 = synth.decode_md5s(T.Decoder(device='cpu'),"
        " [synth.still_picture(72, 40, 3)])\n"
        "assert len(md5) == 1, md5\n"
        "assert T.engine.stats == {'frames': 1, 'fallback': 0,"
        " 'ref_uploads': 0, 'plan_native': 1}\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "ref = [m for m in sys.modules if m.split('.')[0] == 'rav1d_tpu']\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("RAV1D_ENGINE", None)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_packed_pair_order_matches_bitcast():
    """int16 coefficients packed two per word (FrameBlob.add_i16) read
    back in order through torch's int16 view, as lax.bitcast_convert_type
    reads them in the JAX engine; bytes (add_u8) likewise."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.integers(-(1 << 15), 1 << 15, 37).astype(np.int16)
    blob = FrameBlob(0)
    off = blob.add_i16(a)
    words = blob.parts[0][1]
    got = torch.from_numpy(words.copy()).view(torch.int16)[: a.size].numpy()
    np.testing.assert_array_equal(got, a)
    ref = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(words), jnp.int16))
    np.testing.assert_array_equal(got, ref.reshape(-1)[: a.size])
    assert off == 0
    b = rng.integers(0, 256, 13).astype(np.uint8)
    blob = FrameBlob(0)
    blob.add_u8(b)
    from rav1d_tpu_torch.engine.programs import u8_region

    dev = torch.from_numpy(blob.parts[0][1].copy())
    np.testing.assert_array_equal(u8_region(dev, 0, 13).numpy(), b)
