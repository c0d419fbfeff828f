"""The itx kernel's frame entry against the plain resid program, exactly.

csrc/itx.cu compiled for the host with g++ (its host entry walks the
kernel's class table with the kernel's own step functions, thread by
thread) runs ops/cuda/itx.py frame_args over a frame blob and must leave
the residual buffer `ra` equal to engine/programs.resid_plain on the same
blob. This holds, where there is no card, what the kernel adds to the
transforms: the descriptor reads across chunks, the int16-pair unpack,
the column-by-column source order, the clamped coefficient reads, lanes
past the filled count left alone and the drop rule for destinations
outside `ra`.

Blobs: seeded synthetic pictures packed by the port (8 bpc, and 10/12 bpc
with word coefficients in each layout; they carry 12-15 of the 19 sizes
each), and blobs written here with every size and
the WHT at 8 and 10/12 bpc, several chunks per class, odd, negative and
past-the-end coefficient offsets and destinations partly or wholly
outside `ra`. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.layout import (
    CF0, HDR_LEN, R0, SIZES, WHT0, WHT_B, chunk_for,
)
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops.cuda import itx as cuda_itx
from test_torch_itx import build_host_itx, run_host


@pytest.fixture(scope="module")
def host_itx(tmp_path_factory):
    return build_host_itx(tmp_path_factory.mktemp("itx_frame"))


def _kernel_ra(lib, dev, hdr, tx_valid, ah, aw, bpc):
    ra = torch.zeros(6 * ah * aw, dtype=torch.int32)
    run_host(lib, cuda_itx.frame_args(dev, hdr, tx_valid, ra, aw, bpc))
    return ra


# (seed, bpc, layout); the 8-bit cases keep their ids (the seed)
PACKED = [(s, 8, PL.I420) for s in (1, 3, 4, 5, 6, 7)] + [
    (2, 10, PL.I420), (3, 12, PL.I444), (4, 10, PL.I422), (5, 12, PL.I400)]


@pytest.mark.parametrize(
    "seed,bpc,layout", PACKED,
    ids=[str(s) if b == 8 else "%dbit-%s-%d" % (b, l.name, s)
         for s, b, l in PACKED])
def test_frame_entry_matches_resid_plain_on_packed_blobs(host_itx, seed, bpc,
                                                         layout):
    (f, plan), = synth.capture_frames([synth.still_picture(
        256, 128, seed, bpc=bpc, layout=layout)])
    pk = pack_frame(f, plan)
    dev, _ = Uploader("cpu").upload(pk, plan.ah * plan.aw, bpc)
    ref, _ = P.resid_plain(dev, pk.hdr, pk.tx_valid, ah=plan.ah, aw=plan.aw,
                           bpc=bpc)
    got = _kernel_ra(host_itx, dev, pk.hdr, pk.tx_valid, plan.ah, plan.aw,
                     bpc)
    assert ref.any() and len(pk.tx_valid) >= 2
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _written_blob(bpc, seed):
    """A frame blob with blocks of every size and the WHT: (words, hdr,
    tx_valid, ah, aw). Blocks are shelf-packed into ra's rows between a
    free band at each end; extra blocks start in those bands, so some of
    their rows fall before 0 or past the end of ra and are dropped."""
    rng = np.random.default_rng(seed)
    ah, aw = 256, 256
    n_rows = 6 * ah
    counts = {wh: int(rng.integers(3, 12 if max(wh) >= 32 else 40))
              for wh in SIZES}
    counts[(64, 64)] = 34  # two chunks of 32
    counts[(32, 8)] = 70   # two chunks of 64
    counts["wht"] = 300    # two chunks of 256
    blocks = sorted(((k, i) for k, n in counts.items() for i in range(n)),
                    key=lambda b: -(4 if b[0] == "wht" else b[0][1]))
    flat0 = {}
    x, y, shelf = 0, 64, 0
    for k, i in blocks:
        w, h = (4, 4) if k == "wht" else k
        if x + w > aw:
            x, y, shelf = 0, y + shelf, 0
        flat0[k, i] = y * aw + x
        x += w
        shelf = max(shelf, h)
    assert y + shelf <= n_rows - 64
    # blocks that run off either end of ra
    edge = {(64, 64): [-40 * aw + 8, (n_rows - 20) * aw + 64],
            (16, 32): [-(32 + 5) * aw, (n_rows - 1) * aw + 200],
            "wht": [-2 * aw + 100, n_rows * aw + 3, 2**31 - 3]}
    for k, ds in edge.items():
        for d in ds:
            flat0[k, counts[k]] = d
            counts[k] += 1

    cf = []
    cf_pos = 0
    offs = {}
    for k in counts:
        w, h = (4, 4) if k == "wht" else k
        m = min(h, 32) * min(w, 32)
        for i in range(counts[k]):
            if bpc == 8:
                v = rng.integers(-(2**15), 2**15, size=m, dtype=np.int64)
            else:
                v = rng.integers(-(1 << (bpc + 8)), 1 << (bpc + 8), size=m)
                v[: m // 8] = rng.integers(-(2**31), 2**31 - 1, size=m // 8)
            offs[k, i] = cf_pos
            cf.append(v)
            cf_pos += m
    cf = np.concatenate(cf)
    # odd, negative and past-the-end offsets (reads clamp into the blob)
    offs[(8, 8), 0] += 1
    offs[(4, 16), 1] = -51
    offs[(32, 32), 2] = 10**7

    hdr = np.zeros(HDR_LEN, np.int32)
    words = [hdr]
    pos = HDR_LEN
    hdr[CF0] = pos
    if bpc == 8:
        cfw = cf.astype(np.int16)
        cfw = np.concatenate([cfw, np.zeros(cfw.size & 1, np.int16)])
        cfw = cfw.view(np.int32)
    else:
        cfw = cf.astype(np.int32)
    words.append(cfw)
    pos += cfw.size
    tx_valid = {}
    for k, n in counts.items():
        w, h = (4, 4) if k == "wht" else k
        if k == "wht":
            B, nrows, reg, key = WHT_B, 2, WHT0, "wht"
        else:
            si = SIZES.index(k)
            B, nrows, reg, key = chunk_for(w, h), 4, R0 + 2 * si, si
        nc = (n + B - 1) // B
        # lanes past n hold destinations inside ra and valid codes: the
        # kernel must not touch them
        d = np.zeros((nrows, nc * B), np.int64)
        d[1] = rng.integers(0, 6 * ah * aw, size=nc * B)
        for i in range(n):
            d[0, i] = offs[k, i]
            d[1, i] = flat0[k, i]
        if nrows == 4:
            nv_w = 4 if w <= 16 else (2 if w == 32 else 1)
            nv_h = 4 if h <= 16 else (2 if h == 32 else 1)
            d[2] = rng.integers(0, nv_w, size=nc * B)
            d[3] = rng.integers(0, nv_h, size=nc * B)
            d[2, 0] = d[3, 1] = 5  # codes the size lacks run the dct
            d[2, 1] = d[3, 0] = 3
        region = d.reshape(nrows, nc, B).transpose(1, 0, 2).astype(np.int32)
        hdr[reg], hdr[reg + 1] = pos, nc
        words.append(region.reshape(-1))
        pos += region.size
        tx_valid[key] = n
    words.append(np.zeros(37, np.int32))  # capacity padding
    return np.concatenate(words), hdr, tx_valid, ah, aw


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_frame_entry_matches_resid_plain_on_written_blobs(host_itx, bpc):
    words, hdr, tx_valid, ah, aw = _written_blob(bpc, 100 + bpc)
    dev = torch.from_numpy(words)
    ref, _ = P.resid_plain(dev, hdr, tx_valid, ah=ah, aw=aw, bpc=bpc)
    got = _kernel_ra(host_itx, dev, hdr, tx_valid, ah, aw, bpc)
    assert len(cuda_itx.frame_table(hdr, tx_valid, dev.numel())) == 20
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_resid_runs_the_plain_version_on_the_cpu():
    """On a CPU tensor resid is resid_plain, and the plain transforms are
    counted."""
    from rav1d_tpu_torch.engine import kernels

    words, hdr, tx_valid, ah, aw = _written_blob(8, 7)
    dev = torch.from_numpy(words)
    before = kernels.calls
    ra, planes = P.resid(dev, hdr, tx_valid, ah=ah, aw=aw, bpc=8)
    assert kernels.calls - before == 20
    ref, _ = P.resid_plain(dev, hdr, tx_valid, ah=ah, aw=aw, bpc=8)
    assert torch.equal(ra, ref) and not planes.any()


def test_frame_table_rejects_a_region_outside_the_blob():
    words, hdr, tx_valid, _, _ = _written_blob(8, 3)
    with pytest.raises(ValueError):
        cuda_itx.frame_table(hdr, tx_valid, HDR_LEN + 10)
