"""Whether the pictures the timed path returned are right: a sample of
the window's groups, drawn from the seed, decoded again by the plain
reference (avbench/reference/, a frozen copy of the decoder's numpy host
path) in worker processes once the window has closed and the decoder is
gone, and compared digest by digest (exact: the limit is 0).

The numbers compared: `mismatched`, pictures of the sample whose digest
differs from the reference's (at most 0); `missing`, units sent in the
window whose picture never came, even after the drain, or that the
decoder refused (at most 0); `checked`, pictures compared (at least 1);
`fallback`, frames of the window that the decoder sent down its numpy
host path instead of the card (engine.stats["fallback"] over the window;
at most 0): such a frame leaves the card idle while the picture is still
right, so a window with one measures another program.
"""

from __future__ import annotations

import multiprocessing
from dataclasses import dataclass

import numpy as np

from . import streams
from .window import digest

LIMITS = {"mismatched": ("max", 0), "missing": ("max", 0), "checked": ("min", 1),
          "fallback": ("max", 0)}


@dataclass
class Checks:
    mismatched: int = 0
    missing: int = 0
    checked: int = 0
    fallback: int = 0
    groups: tuple = ()

    @property
    def correct(self):
        return all(_holds(getattr(self, k), rule, lim)
                   for k, (rule, lim) in LIMITS.items())

    def numbers(self):
        """Each number compared beside its limit."""
        return {k: {"value": getattr(self, k), rule: lim}
                for k, (rule, lim) in LIMITS.items()}


def _holds(value, rule, limit):
    return value <= limit if rule == "max" else value >= limit


def sample_groups(stream, sent, seed, k):
    """`k` groups, drawn from `seed`, of those whose units were sent in
    the window (units 0 .. sent-1, cycling over the stream)."""
    n = len(stream.units)
    seen = sorted({stream.group[ts % n] for ts in range(sent)})
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0xC4EC])
    pick = rng.choice(len(seen), size=min(k, len(seen)), replace=False)
    return sorted(seen[i] for i in pick)


def reference_digests(config, traffic, group_seed):
    """The reference's digest of each picture of one group (in a worker:
    the group is written again from its seed)."""
    from .reference import Decoder, EAgain, Settings

    units = streams.write_group(config, traffic, group_seed)
    dec = Decoder(Settings(**config["settings"]))
    out = []
    for data in units:
        dec.send_data(data)
        while True:
            try:
                out.append(digest(dec.get_picture()))
            except EAgain:
                break
    return out


def compare(stream, sent, got, ref):
    """Checks of the program's digests `got` (unit -> digest) against the
    reference's `ref` (group -> digests in unit order)."""
    n = len(stream.units)
    pos, count = [], {}  # each unit's place in its group
    for g in stream.group:
        pos.append(count.get(g, 0))
        count[g] = pos[-1] + 1
    c = Checks(groups=tuple(sorted(ref)))
    for ts in range(sent):
        d = got.get(ts)
        if d is None:
            c.missing += 1
            continue
        g = stream.group[ts % n]
        if g in ref:
            c.checked += 1
            c.mismatched += int(d != ref[g][pos[ts % n]])
    return c


def run(config, traffic, stream, sent, got, seed, workers, fallback=0):
    """Decode the sampled groups on the reference (`workers` processes)
    and compare; `fallback` is the window's count of host-path frames."""
    groups = sample_groups(stream, sent, seed, traffic["check_groups"])
    from . import reference  # noqa: F401  (builds the C syntax pass once)

    args = [(config, traffic, stream.seeds[g]) for g in groups]
    if workers <= 1 or len(args) <= 1:
        digs = [reference_digests(*a) for a in args]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(args))) as pool:
            digs = pool.starmap(reference_digests, args)
            pool.close()
            pool.join()
    checks = compare(stream, sent, got, dict(zip(groups, digs)))
    checks.fallback = int(fallback)
    return checks
