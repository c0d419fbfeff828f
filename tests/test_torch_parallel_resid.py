"""rav1d_tpu_torch.parallel.resid on gloo: the frame's inverse-transform
batch split over 1, 2, 4 and 8 CPU processes.

Each frame is a 320x192 synthetic still picture (synth.still_picture with
segmentation, seed 1) at 8 and at 10 bits, whose lossless segment gives
WHT blocks, which group_residuals leaves out. For each world size,
torch.multiprocessing starts the ranks, which join a gloo process group
through a file:// init in tmp_path, and each computes
sharded_residual_plane on the port's capture of the frame. On every rank
the plane must equal

- the port's single_device_residual_plane (no collective, the plain
  transforms), and
- rav1d_tpu.parallel.resid.single_device_residual_plane, called directly
  on rav1d_tpu.parallel.resid.capture_frame of the same bytes written to
  an IVF file by synth.write_ivf (computed once per bit depth: padded
  lanes drop, so it does not depend on the shard count).

The port's group_residuals must equal the reference's array by array.
Each rank must transform each size group in one batch. Tolerance: exact.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import kernels
from rav1d_tpu_torch.parallel import resid as R
from rav1d_tpu_torch.syntax.levels import WHT_WHT
from rav1d_tpu_torch.synth import Tools

W, H = 320, 192
BPCS = (8, 10)
WORLDS = (1, 2, 4, 8)


def packets_of(bpc):
    return [synth.still_picture(W, H, 1, bpc=bpc,
                                tools=Tools(segmentation=True))]


def inputs_of(f):
    """(store, cf values, psz, aw, bpc) of a captured frame."""
    store = f.coef_store
    ah, aw = f.cur.y.shape
    return store, store.cf[: store.cf_pos].copy(), ah * aw, aw, f.cur.bpc


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Per bpc: the port's frame inputs and the reference's oracle plane,
    from the reference's own capture of the same bytes in an IVF file."""
    import jax.numpy as jnp

    from rav1d_tpu.parallel import resid as JR

    out = {}
    for bpc in BPCS:
        packets = packets_of(bpc)
        path = str(tmp_path_factory.mktemp("ivf") / f"still{bpc}.ivf")
        synth.write_ivf(path, packets, W, H)
        store, cf, psz, aw, b = inputs_of(R.capture_frame(packets))
        assert b == bpc
        rf = JR.capture_frame(path, frame_idx=0)
        rstore = rf.coef_store
        assert rf.cur.y.shape[0] * rf.cur.y.shape[1] == psz
        np.testing.assert_array_equal(rstore.cf[: rstore.cf_pos], cf)
        oracle = np.asarray(JR.single_device_residual_plane(
            jnp.asarray(cf), JR.group_residuals(rstore, psz, aw, 1), psz, aw,
            bpc))
        out[bpc] = dict(store=store, rstore=rstore, cf=cf, psz=psz, aw=aw,
                        oracle=oracle)
    return out


def test_frames_have_work_and_wht(frames):
    for bpc, fr in frames.items():
        store = fr["store"]
        sel = np.arange(store.tx_pos)
        sel = sel[store.eob[sel] >= 0]
        n_wht = int((store.txtp[sel] == WHT_WHT).sum())
        assert n_wht > 0 and sel.size - n_wht > 100, (bpc, sel.size, n_wht)
        groups = R.group_residuals(store, fr["psz"], fr["aw"], 1)
        assert sum(int((g[3] < 3 * fr["psz"]).sum()) for g in groups) == (
            sel.size - n_wht)
        assert np.abs(fr["oracle"]).sum() > 0


@pytest.mark.parametrize("n_shards", WORLDS)
def test_group_residuals_matches_reference(frames, n_shards):
    from rav1d_tpu.parallel import resid as JR

    for bpc, fr in frames.items():
        got = R.group_residuals(fr["store"], fr["psz"], fr["aw"], n_shards)
        want = JR.group_residuals(fr["rstore"], fr["psz"], fr["aw"],
                                  n_shards)
        assert len(got) == len(want) > 5
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            assert g[2].shape[0] % n_shards == 0
            for a, b in zip(g[2:], w[2:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bpc", BPCS)
def test_single_device_plane_matches_reference(frames, bpc):
    fr = frames[bpc]
    groups = R.group_residuals(fr["store"], fr["psz"], fr["aw"], 1)
    calls = kernels.calls
    got = R.single_device_residual_plane(torch.from_numpy(fr["cf"]), groups,
                                         fr["psz"], fr["aw"], bpc)
    assert kernels.calls - calls == len(groups)  # one batch per size group
    np.testing.assert_array_equal(got.numpy(), fr["oracle"])


def _rank(rank, world, init, jobs, out_dir):
    """One rank: join the gloo group, then per job (bpc, cf, groups, psz,
    aw) the sharded plane and the plain transform calls it made. One
    intra-op thread per rank: the ranks share the machine's cores."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        for bpc, cf, groups, psz, aw in jobs:
            calls = kernels.calls
            plane = R.sharded_residual_plane(torch.from_numpy(cf), groups,
                                             psz, aw, bpc)
            np.save(os.path.join(out_dir, f"plane{bpc}_{rank}.npy"),
                    plane.numpy())
            np.save(os.path.join(out_dir, f"calls{bpc}_{rank}.npy"),
                    np.int64(kernels.calls - calls))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_plane_equals_both_oracles(frames, world, tmp_path):
    jobs, groups = [], {}
    for bpc, fr in frames.items():
        groups[bpc] = R.group_residuals(fr["store"], fr["psz"], fr["aw"],
                                        world)
        jobs.append((bpc, fr["cf"], groups[bpc], fr["psz"], fr["aw"]))
    init = "file://" + str(tmp_path / "init")
    # ranks fork from a fresh server process that has imported this module
    # (torch, the port) once, not from this process (JAX is loaded here)
    multiprocessing.set_forkserver_preload([__name__])
    mp.start_processes(_rank, args=(world, init, jobs, str(tmp_path)),
                       nprocs=world, join=True, start_method="forkserver")
    for bpc, fr in frames.items():
        single = R.single_device_residual_plane(
            torch.from_numpy(fr["cf"]), groups[bpc], fr["psz"], fr["aw"],
            bpc).numpy()
        np.testing.assert_array_equal(single, fr["oracle"])
        for rank in range(world):
            got = np.load(tmp_path / f"plane{bpc}_{rank}.npy")
            np.testing.assert_array_equal(got, single)
            # one itx batch per (rank, size group)
            assert int(np.load(tmp_path / f"calls{bpc}_{rank}.npy")) == (
                len(groups[bpc]))
