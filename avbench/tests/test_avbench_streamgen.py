"""The frozen generator writes the streams the port's generator wrote
when it was copied, byte for byte."""

import hashlib

from avbench import streamgen, streams

# MD5s of the port's rav1d_tpu_torch/synth.py at the copy
GROUP_640x360_SEED21 = "3e65241d30d32183bc1b4772335ed8e6"
STILL_640x360_SEED22 = "3dc14a18603bdd077f09a4a834a74265"


def test_pinned_group_and_still():
    group = streamgen.inter_sequence(640, 360, 21)
    assert hashlib.md5(b"".join(group)).hexdigest() == GROUP_640x360_SEED21
    still = streamgen.still_picture(640, 360, 22)
    assert hashlib.md5(still).hexdigest() == STILL_640x360_SEED22


def test_group_seeds_take_large_seeds_and_repeat():
    a = streams.group_seeds(2**32 + 12345, 5)
    assert a == streams.group_seeds(2**32 + 12345, 5)
    assert a != streams.group_seeds(2**32 + 12346, 5)
    assert len(set(a)) == 5


def test_every_seed_orders_the_same_pool():
    cfg = dict(width=64, height=64, bpc=8, layout="I420")
    tr = dict(generator="inter_sequence", groups=2, pool_seed=4)
    s = streams.make(cfg, tr, 9)
    assert sorted(s.group) == [0, 0, 0, 1, 1, 1]
    assert s.group[:3] == [s.group[0]] * 3
    one = [u for u, g in zip(s.units, s.group) if g == 1]
    assert one == streamgen.inter_sequence(64, 64, s.seeds[1])
    tr = dict(generator="still_picture", groups=6, pool_seed=4)
    a, b = streams.make(cfg, tr, 2**32 + 1), streams.make(cfg, tr, 2**32 + 2)
    assert a.seeds == b.seeds and sorted(a.units) == sorted(b.units)
    assert a.group != b.group and sorted(a.group) == list(range(6))
    assert a.units == streams.make(cfg, tr, 2**32 + 1).units
