"""The frame's inverse-transform batch split over the ranks of a
torch.distributed process group.

Counterpart of rav1d_tpu/parallel/resid.py, which shards the same batch
over a JAX device mesh. The coefficient blocks of a frame (its coefficient
store, after the syntax pass) are grouped by transform size into
descriptor chunks (`group_residuals`, padded so that every rank gets the
same number of chunks, lossless WHT blocks left out). Each rank
inverse-transforms its contiguous share of every group in one batch per
group, through the itx kernel's per-size entry point (ops/cuda/itx.py
`itx`: one launch of the hand-written kernel on a CUDA tensor, its plain
version engine/kernels.itx_any_core on a CPU tensor), and scatters the
residuals into a zero plane. One all_reduce(SUM) over the group combines
the ranks' disjoint writes into the plane `single_device_residual_plane`
computes with no collective.

The reference drops padded lanes by scattering to an out-of-range sentinel
(flat0 = 3 * psz) with mode="drop"; torch indexing raises on an
out-of-range index, so the scatter here masks them explicitly, sending
them to one slot past the plane. The reference psums each size group's
plane; the groups' blocks are disjoint, so one all_reduce over their sum
gives the same plane.

The process group is the caller's: initialize it (gloo for CPU tensors,
NCCL for CUDA tensors) before the call. Nothing here reads the
environment, and nothing catches a failed launch or collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..engine.kernels import itx_any_core
from ..engine.layout import TXTP_FIRST, TXTP_SECOND, chunk_for
from ..ops.cuda.itx import itx
from ..syntax.levels import WHT_WHT

I32 = torch.int32


def group_residuals(store, psz, aw, n_shards):
    """Chunk a frame's coefficient store into per-(w, h) descriptor stacks,
    padded so every shard gets the same number of chunks.

    Returns [(w, h, offs (K, B), flat0 (K, B), fs (K, 2, B))] with
    K % n_shards == 0; padded lanes/chunks carry flat0 = 3*psz and drop at
    scatter time (same convention as engine/kernels.py plan_residuals)."""
    sel = np.arange(store.tx_pos)
    sel = sel[store.eob[sel] >= 0]
    if not sel.size:
        return []
    tps = store.txtp[sel].astype(np.int64)
    sel = sel[tps != WHT_WHT]  # WHT rides the engine's dedicated kernel
    tps = store.txtp[sel].astype(np.int64)
    ws = store.txw[sel].astype(np.int64)
    hs = store.txh[sel].astype(np.int64)
    flat0_all = (
        store.txpl[sel].astype(np.int64) * psz
        + store.txy[sel].astype(np.int64) * aw
        + store.txx[sel]
    ).astype(np.int32)
    key = ws * 2048 + hs
    groups = []
    oob = np.int32(3 * psz)
    for k in np.unique(key):
        gsel = key == k
        w = int(k) // 2048
        h = int(k) % 2048
        B = chunk_for(w, h)
        offs = store.cf_off[sel[gsel]].astype(np.int32)
        flat0 = flat0_all[gsel]
        fsv = TXTP_FIRST[tps[gsel]]
        ssv = TXTP_SECOND[tps[gsel]]
        n = offs.size
        K = -(-n // B)  # chunks
        K = -(-K // n_shards) * n_shards  # pad to shard multiple
        o = np.zeros((K, B), np.int32)
        f0 = np.full((K, B), oob, np.int32)
        fs = np.zeros((K, 2, B), np.int32)
        flat_o = o.reshape(-1)
        flat_f = f0.reshape(-1)
        flat_o[:n] = offs
        flat_f[:n] = flat0
        for i in range(0, n, B):
            m = min(B, n - i)
            ci = i // B
            fs[ci, 0, :m] = fsv[i : i + m]
            fs[ci, 1, :m] = ssv[i : i + m]
        groups.append((w, h, o, f0, fs))
    return groups


def _shares(groups, dev, r=0, n=1):
    """Rank r of n's chunks [r*K/n, (r+1)*K/n) of each size group, as
    [(w, h, offs, first codes, second codes, flat0)] with (lanes,) int32
    tensors on `dev`: the descriptors of every group in one copy to the
    device, so no later step of the call waits for the host."""
    parts = []
    for w, h, offs, flat0, fs in groups:
        K = offs.shape[0]
        if K % n:
            raise ValueError(f"{K} chunks of {w}x{h} do not split over {n} "
                             "ranks")
        k0, k1 = r * K // n, (r + 1) * K // n
        parts.append(np.stack([offs[k0:k1].reshape(-1),
                               fs[k0:k1, 0].reshape(-1),
                               fs[k0:k1, 1].reshape(-1),
                               flat0[k0:k1].reshape(-1)]))
    if not parts:
        return []
    desc = torch.from_numpy(np.concatenate(parts, axis=1)).to(dev)
    out, at = [], 0
    for (w, h, *_), part in zip(groups, parts):
        m = part.shape[1]
        out.append((w, h, *desc[:, at : at + m]))
        at += m
    return out


def _gather(cfbuf, offs, w, h):
    """(lanes, min(h,32), min(w,32)) int32 coefficient blocks in natural
    order, gathered as the reference does from blocks stored column by
    column at `offs`. Reads past the end of cfbuf (only padded lanes,
    whose offset is 0, make them) are clamped."""
    sh, sw = min(h, 32), min(w, 32)
    idx = offs[:, None].long() + torch.arange(sh * sw,
                                              device=cfbuf.device)[None, :]
    cb = cfbuf[idx.clamp_(max=cfbuf.numel() - 1)].to(I32)
    return cb.reshape(-1, sw, sh).transpose(1, 2).contiguous()


def _scatter(plane, res, flat0, w, h, aw):
    """plane[flat0 + y*aw + x] = res[:, y, x] where that index is below
    n = plane.numel() - 1; the rest (padded lanes' sentinel 3*psz, rows
    past the last plane) go to the plane's last element, a slot that is
    not part of the residual plane (a masked index, so the scatter needs
    no count from the device)."""
    dev = plane.device
    n = plane.numel() - 1
    idx = (flat0[:, None, None].long()
           + torch.arange(h, device=dev)[None, :, None] * aw
           + torch.arange(w, device=dev)[None, None, :])
    keep = (idx >= 0) & (idx < n)
    plane[torch.where(keep, idx, n)] = res


def _plane(psz, dev):
    """A zero (3*psz + 1,) int32 buffer: the residual plane and the drop
    slot of _scatter."""
    return torch.zeros(3 * psz + 1, dtype=I32, device=dev)


def sharded_residual_plane(cfbuf, groups, psz, aw, bpc, *, group=None):
    """The frame residual plane ((3*psz,) int32, on cfbuf's device, equal
    on every rank) with each group_residuals chunk stack split over the
    ranks of `group` (default: the world), as P(axis) sharding splits it:
    rank r of n takes chunks [r*K/n, (r+1)*K/n). Each rank transforms its
    chunks of a size group in one batch (ops/cuda/itx.py itx), scatters
    them, and one all_reduce(SUM) over the group sums the ranks' planes.
    cfbuf: the coefficient store's values (cf[:cf_pos]), int32; groups
    must come from group_residuals with n_shards = the group's size."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    if cfbuf.device.type == "cuda" and dist.get_backend(group) != "nccl":
        raise ValueError("sharded_residual_plane: a CUDA plane needs an NCCL "
                         f"process group, not {dist.get_backend(group)}")
    buf = _plane(psz, cfbuf.device)
    for w, h, offs, first, second, f0 in _shares(groups, cfbuf.device, r, n):
        res = itx(_gather(cfbuf, offs, w, h), first, second, w, h, bpc)
        _scatter(buf, res, f0, w, h, aw)
    plane = buf[: 3 * psz]
    dist.all_reduce(plane, op=dist.ReduceOp.SUM, group=group)
    return plane


def single_device_residual_plane(cfbuf, groups, psz, aw, bpc):
    """Oracle: the same gather and masked scatter on one device, every
    chunk of a size group in one batch through the plain transform
    (engine/kernels.itx_any_core), no collective."""
    buf = _plane(psz, cfbuf.device)
    for w, h, offs, first, second, f0 in _shares(groups, cfbuf.device):
        res = itx_any_core(_gather(cfbuf, offs, w, h), first, second, w, h,
                           bpc)
        _scatter(buf, res, f0, w, h, aw)
    return buf[: 3 * psz]


def capture_frame(packets, frame_idx=0):
    """The FrameContext of frame `frame_idx` of `packets` after its syntax
    pass (real coefficients, real geometry), decoded on the port's host
    path (synth.capture_frames)."""
    from ..synth import capture_frames

    return capture_frames(packets)[frame_idx][0]
