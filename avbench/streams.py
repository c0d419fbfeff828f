"""The one stream generator: a configuration (picture format) and a
traffic mix (which generator, its header tools, how many groups) give the
temporal units of a cell's stream for a seed.

A group is what one call of the frozen generator writes: a key frame and
its inter frames (`inter_sequence`), or one key frame
(`still_picture`). Every group starts with a sequence header and a key
frame, so the groups follow each other with no flush, as a stream plays,
and each can be decoded alone.

The groups are a pool fixed by the traffic mix: group i takes the i-th
word that `numpy.random.SeedSequence(traffic["pool_seed"])` generates as
its seed. The run's `--seed` orders the pool (a permutation drawn from
it), and the window cycles over that order. So every seed decodes the
same set of pictures in another order: random tile data makes one
picture's work differ from another's by tens of percent, and a set drawn
anew for each seed would move the end-to-end metrics more than the
host's own noise does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import streamgen


@dataclass
class Stream:
    units: list   # bytes: one temporal unit each, in decode order
    group: list   # the group of each unit
    seeds: list   # each group's seed


def group_seeds(seed, n):
    """`n` group seeds drawn from `seed` (any whole number)."""
    entropy = int(seed) & ((1 << 64) - 1)
    return [int(s) for s in np.random.SeedSequence(entropy).generate_state(n)]


def write_group(config, traffic, seed):
    """The temporal units of one group."""
    tools = dict(traffic.get("tools", {}))
    if "tiles" in tools:
        tools["tiles"] = tuple(tools["tiles"])
    kw = dict(bpc=config["bpc"], layout=streamgen.PixelLayout[config["layout"]],
              tools=streamgen.Tools(**tools))
    gen = traffic["generator"]
    w, h = config["width"], config["height"]
    if gen == "inter_sequence":
        return streamgen.inter_sequence(w, h, seed, **kw)
    if gen == "still_picture":
        return [streamgen.still_picture(w, h, seed, **kw)]
    raise ValueError(f"unknown generator {gen!r}")


def order(seed, n):
    """The order of the pool's `n` groups for `seed` (any whole number)."""
    entropy = int(seed) & ((1 << 64) - 1)
    return [int(g) for g in np.random.default_rng(entropy).permutation(n)]


def make(config, traffic, seed):
    """The cell's stream for `seed`: the traffic's pool of
    traffic["groups"] groups, in the order `seed` draws."""
    seeds = group_seeds(traffic["pool_seed"], traffic["groups"])
    units, group = [], []
    for g in order(seed, len(seeds)):
        for u in write_group(config, traffic, seeds[g]):
            units.append(u)
            group.append(g)
    return Stream(units, group, seeds)


def warmup(config, traffic):
    """The group decoded in set-up: the same for every seed
    (traffic["warmup_seed"]), so set-up does the same work each run."""
    return write_group(config, traffic, traffic["warmup_seed"])
