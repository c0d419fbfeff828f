"""The device engine on torch: packers, programs and the frame runner.

Counterpart of rav1d_tpu/engine/__init__.py: intra and inter frames at
every bit depth and chroma layout, with superres. `stats` counts the frames
the engine was asked to decode, the ones it handed to the numpy host path
(the reference's own gates: intra block copy, scaled references, an inter
pool that would overflow), the host reference planes it uploaded
(engine/run.py dev_plane: planes of pictures the host path decoded), and
the frames the native key-frame planner planned (engine/plan.py
_plan_native).
"""

from __future__ import annotations

stats = {"frames": 0, "fallback": 0, "ref_uploads": 0, "plan_native": 0}


def run_dense(t, f, up) -> bool:
    """Run the frame's dense pass on the device of `up` (an engine/blob.py
    Uploader). Returns False when the planner declines the frame (caller
    runs the host path)."""
    from .plan import build_plan
    from .run import execute

    plan = build_plan(t, f)
    # counted once planned, beside plan_native: a frame still being planned
    # when another thread reads the counts is in neither
    stats["frames"] += 1
    if plan is not None and plan.native is not None:
        stats["plan_native"] += 1
    ok = plan is not None and execute(f, plan, up)
    if not ok:
        stats["fallback"] += 1
    return ok
