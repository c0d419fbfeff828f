"""Host-clock spans around the port's layers, put in from the outside.

In a traced run, `Tracer.install` wraps the port's functions at run time
(none is changed in the program) and hooks `gc.callbacks`:

| span | wrapped | layer |
|---|---|---|
| syntax | recon/frame.py decode_frame_syntax (the C syntax pass) | front end |
| plan | recon/frame.py materialize_work_items, engine/plan.py build_plan | planner |
| pack | engine/run.py pack_frame | pack |
| upload | engine/blob.py Uploader.upload | upload |
| execute | engine/run.py execute (pack, upload, the program launches) | device programs |
| grain | engine/grain.py apply | grain |
| gc | a collection of generation 1 or 2 | host runtime |

The harness adds "send_data" and "get_picture" around the caller's calls.
A span is (name, start, end) on the host clock (time.perf_counter), from
any thread. Frame facts for the kernel bound are taken in `execute` and
`grain`, keyed by the picture's unit (its timestamp); stream facts (wave levels, inter tiles) from what `build_plan`
and `pack_frame` return.
"""

from __future__ import annotations

import gc
import threading
import time

from . import roofline


class Tracer:
    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.spans = []          # (name, t0, t1)
        self.totals = {}         # name -> seconds
        self.counts = {}         # name -> calls
        self.gc_s = 0.0          # the collector's time, every generation
        self.bytes_by_unit = {}  # the kernel bound's bytes (roofline.py)
        self.frames = 0          # frames the engine ran on the device
        self.grained = 0         # pictures grained on the device
        self.waves = 0           # wave levels of the planned frames
        self.inter_tiles = 0     # inter tiles of the packed frames
        self._undo = []
        self._gc_t0 = None
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------

    def add(self, name, t0, t1):
        with self._lock:
            self.spans.append((name, t0, t1))
            self.totals[name] = self.totals.get(name, 0.0) + (t1 - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = self.clock()
            return
        if self._gc_t0 is None:
            return
        t1 = self.clock()
        self.gc_s += t1 - self._gc_t0
        if info["generation"] >= 1:
            self.add("gc", self._gc_t0, t1)
        self._gc_t0 = None

    def _wrap(self, owner, attr, name, after=None, before=None):
        orig = getattr(owner, attr)
        clock = self.clock

        def wrapped(*args, **kw):
            if before is not None:
                before(*args, **kw)
            t0 = clock()
            try:
                out = orig(*args, **kw)
            finally:
                self.add(name, t0, clock())
            if after is not None:
                after(out, *args, **kw)
            return out

        wrapped.__wrapped__ = orig
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    # -- facts ---------------------------------------------------------

    def _on_plan(self, plan, *args, **kw):
        if plan is not None:
            self.waves += int(plan.n_waves)

    def _on_pack(self, pack, *args, **kw):
        if pack is not None and pack.srcs is not None:
            self.inter_tiles += sum(r.n for runs in pack.inter_runs.values()
                                    for r in runs)

    def _on_execute(self, ok, f, plan, up):
        if ok:
            self.frames += 1
            self._bytes(f.sr_cur.timestamp, roofline.frame_bytes(f))

    def _on_grain(self, pic, *args, **kw):
        self.grained += 1
        self._bytes(pic.timestamp, roofline.grain_bytes(pic))

    def _bytes(self, unit, n):
        with self._lock:
            self.bytes_by_unit[unit] = self.bytes_by_unit.get(unit, 0) + n

    # -- install -------------------------------------------------------

    def install(self):
        """Wrap the port's layers and hook the collector."""
        from rav1d_tpu_torch.engine import blob, grain, plan, run
        from rav1d_tpu_torch.recon import frame

        self._wrap(frame, "decode_frame_syntax", "syntax")
        self._wrap(frame, "materialize_work_items", "plan")
        self._wrap(plan, "build_plan", "plan", after=self._on_plan)
        self._wrap(run, "pack_frame", "pack", after=self._on_pack)
        self._wrap(blob.Uploader, "upload", "upload")
        self._wrap(run, "execute", "execute", after=self._on_execute)
        self._wrap(grain, "apply", "grain", after=self._on_grain)
        gc.callbacks.append(self._gc)

    def uninstall(self):
        if self._gc in gc.callbacks:
            gc.callbacks.remove(self._gc)
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
