"""The port's three programs against the JAX engine's, on one blob.

For small synthetic intra frames: rav1d_tpu_torch engine/programs.py
resid, wave and filter_ against rav1d_tpu engine/mega.py resid_prog,
wave_prog and filter_prog on the CPU. Each package decodes the same bytes
through its own front end and packs its own blob; the two blobs must be
word-identical, and each package's programs read its own. Compared:
the residual buffer `ra`, the planes after the wavefront, and the
filtered planes and packed output bytes. Each program of the port runs on
the JAX program's own input, so a mismatch names its program. Tolerance:
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.engine import mega as JM
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.pack import pack_frame
from test_torch_pack import ref_capture, run2_pack, run2_words

# same geometry (one JAX compile per program), different tools: seed 10
# has palette, filter intra, CfL, 32/64-point transforms, wiener + mixed
# self-guided LR; seed 6 has all three self-guided kinds
FRAMES = [(136, 96, 10), (136, 96, 6)]


@pytest.fixture(scope="module", params=FRAMES, ids=lambda p: "%dx%d-s%d" % p)
def frame(request):
    """(port frame, plan, FramePack, port device blob, JAX device blob)."""
    w, h, seed = request.param
    packets = [synth.still_picture(w, h, seed)]
    (f, plan), = synth.capture_frames(packets)
    pk = pack_frame(f, plan)
    psz = plan.ah * plan.aw
    dev, cap = Uploader("cpu").upload(pk, psz, 8)
    (rf, rplan), = ref_capture(packets)
    words = run2_words(*run2_pack(rf, rplan)[:2])
    ref = np.zeros(cap, np.int32)
    ref[: words.size] = words
    np.testing.assert_array_equal(dev.numpy(), ref)
    return f, plan, pk, dev, jnp.asarray(ref)


def _statics(f, plan):
    layout = int(f.cur.layout)
    ach, acw = f.sr_cur.u.shape
    geom = (plan.ah, plan.aw, ach, acw, f.bh, f.bw, f.cur.h)
    return layout, geom


def test_resid(frame):
    f, plan, pk, dev, devj = frame
    ra_j, planes_j = JM.resid_prog(devj, ah=plan.ah, aw=plan.aw, bpc=8)
    ra, planes = P.resid(dev, pk.hdr, pk.tx_valid, ah=plan.ah, aw=plan.aw,
                         bpc=8)
    np.testing.assert_array_equal(ra.numpy(), np.asarray(ra_j))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
    assert np.asarray(ra_j).any()


def test_wave(frame):
    f, plan, pk, dev, devj = frame
    ra_j, planes_j = JM.resid_prog(devj, ah=plan.ah, aw=plan.aw, bpc=8)
    ra_np = np.array(ra_j)
    out_j = JM.wave_prog(planes_j, ra_j, devj, ah=plan.ah, aw=plan.aw, bpc=8,
                         ss_hor=1, ss_ver=1)
    out = P.wave(torch.zeros((3, plan.ah, plan.aw), dtype=torch.int32),
                 torch.from_numpy(ra_np), dev, pk.hdr, pk.waves, ah=plan.ah,
                 aw=plan.aw, bpc=8, ss_hor=1, ss_ver=1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))


def test_filter(frame):
    f, plan, pk, dev, devj = frame
    layout, geom = _statics(f, plan)
    ra_j, planes_j = JM.resid_prog(devj, ah=plan.ah, aw=plan.aw, bpc=8)
    pre = np.asarray(JM.wave_prog(planes_j, ra_j, devj, ah=plan.ah,
                                  aw=plan.aw, bpc=8, ss_hor=1, ss_ver=1))
    planes_jf, packed_j = JM.filter_prog(
        jnp.asarray(pre), devj, geom=geom, bpc=8, layout_i=layout,
        need_sr=False, sr_geom=None, lr_ws=pk.lr_ws)
    planes, packed = P.filter_(torch.from_numpy(pre.copy()), dev, pk.hdr,
                               geom=geom, bpc=8, layout_i=layout,
                               lr_ws=pk.lr_ws)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(planes.to(torch.uint8).numpy(),
                                  np.asarray(planes_jf))
