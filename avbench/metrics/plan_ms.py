"""plan_ms (ms/frame; planner): recon/frame.py materialize_work_items and
engine/plan.py build_plan together, on the host clock."""

from avbench.metrics._common import span_ms_per_picture


def read(run):
    return span_ms_per_picture(run, "plan")
