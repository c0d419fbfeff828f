"""rav1d_tpu_torch runs every engine frame inside its decoder's card.

The current CUDA device is per thread, and the kernels' wrappers launch on
it: a decoder on another card than the current one must enter its own
(`torch.cuda.device(self.device)`) wherever its thread launches or waits,
at delay 1 (the dense pass inline on the caller's thread) as on the frame
ring's worker. Here, on the CPU, torch.cuda.device is replaced by a
recorder of the devices each thread has entered, torch.cuda.is_available
by True, and the dense pass (recon/frame.py decode_frame_dense) by a stub
that notes the device it runs in and leaves a fetch for `get_picture` to
complete (engine/blob.py FetchPool), which notes its device too. A `cuda:1`
decoder at delays 1, 2 and 3, through the API and through the CLI, must run
every frame's dense pass and complete every fetch inside `cuda:1`.
"""

import threading

import pytest
import torch

import rav1d_tpu_torch as T
from rav1d_tpu_torch import cli, synth
from rav1d_tpu_torch.engine.blob import FetchPool
from rav1d_tpu_torch.recon import frame as RF

CARD = torch.device("cuda:1")
_PACKETS = []


def packets():
    """An inter sequence (a key frame and two inter frames)."""
    if not _PACKETS:
        _PACKETS.extend(synth.inter_sequence(136, 96, 2))
    return _PACKETS


class Devices:
    """torch.cuda.device's stand-in: `Devices()(d)` is a context manager
    that pushes d on the calling thread's stack; `current()` is the top
    (None outside every context)."""

    def __init__(self):
        self.local = threading.local()

    def _stack(self):
        if not hasattr(self.local, "stack"):
            self.local.stack = []
        return self.local.stack

    def current(self):
        st = self._stack()
        return st[-1] if st else None

    def __call__(self, device):
        devices = self

        class Context:
            def __enter__(self):
                devices._stack().append(torch.device(device))

            def __exit__(self, *exc):
                devices._stack().pop()

        return Context()


@pytest.fixture
def seen(monkeypatch):
    """{"dense": [the device of each dense pass], "fetch": [the device of
    each fetch's completion]} of decodes with the stand-ins installed."""
    devices = Devices()
    got = {"dense": [], "fetch": []}

    def decode_frame_dense(f, up):
        got["dense"].append(devices.current())
        up.fetches.add(f.sr_cur, torch.empty(1, dtype=torch.uint8),
                       lambda: got["fetch"].append(devices.current()))

    monkeypatch.setattr(torch.cuda, "device", devices)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(RF, "decode_frame_dense", decode_frame_dense)
    return got


@pytest.mark.parametrize("d", [1, 2, 3])
def test_every_frame_runs_inside_the_decoders_device(seen, d):
    dec = T.Decoder(T.Settings(apply_grain=False, max_frame_delay=d),
                    device="cuda:1")
    pics = synth.decode_md5s(dec, packets())
    dec.close()
    n = len(packets())
    assert len(pics) == n
    assert seen == {"dense": [CARD] * n, "fetch": [CARD] * n}


def test_cli_frames_run_inside_its_device(seen, tmp_path):
    """`--device cuda:1 --framedelay 1`: the CLI's decoder enters its card
    (its MD5 muxer reads every picture)."""
    path = str(tmp_path / "in.ivf")
    synth.write_ivf(path, packets(), 136, 96)
    assert cli.main(["-i", path, "--device", "cuda:1", "--framedelay", "1",
                     "--muxer", "md5", "-o", str(tmp_path / "out.md5"),
                     "-q"]) == 0
    n = len(packets())
    assert seen == {"dense": [CARD] * n, "fetch": [CARD] * n}


def test_fetch_completes_inside_the_pools_device(monkeypatch):
    """FetchPool.complete enters its device whatever thread asks (a
    picture materialized outside the decoder's calls)."""
    devices = Devices()
    monkeypatch.setattr(torch.cuda, "device", devices)
    got = []
    pool = FetchPool(CARD, 2)
    pic = type("Pic", (), {})()
    pool.add(pic, torch.empty(1, dtype=torch.uint8),
             lambda: got.append(devices.current()))
    t = threading.Thread(target=pool.complete, args=(pic,))
    t.start()
    t.join()
    assert got == [CARD] and pic._pending_fetch is None and not pool.pending
