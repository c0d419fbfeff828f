"""The control of the correctness check: the plain reference put in the
program's place, its samples kept to the nearest precision below the one
the configuration states (8-bit samples to 4 bits, 10- and 12-bit ones
to 8 bits), run through the harness's own window and check. Its
`mismatched` reading is the check's upper reading; it must come out not
correct.

    python -m avbench.control --workload <cell> --seed <n> --seconds <s>

The benchmark's own runs never run it. It needs no card: the reference
decodes on the host.
"""

from __future__ import annotations

import argparse
import json
import sys

LOWER_BITS = {8: 4, 10: 8, 12: 8}


class ControlDecoder:
    """The reference Decoder behind the port's send_data / get_picture,
    each picture's samples cut to `bits` bits (the low bits cleared)."""

    def __init__(self, settings, bpc):
        from rav1d_tpu_torch.decoder import EAgain

        from . import reference

        self._eagain = EAgain
        self._ref_eagain = reference.EAgain
        self.dec = reference.Decoder(reference.Settings(
            n_threads=settings.n_threads,
            max_frame_delay=settings.max_frame_delay,
            apply_grain=settings.apply_grain))
        self.shift = bpc - LOWER_BITS[bpc]

    def send_data(self, data, timestamp=0):
        self.dec.send_data(data, timestamp)

    def get_picture(self):
        try:
            pic = self.dec.get_picture()
        except self._ref_eagain as e:
            raise self._eagain(str(e)) from e
        for plane in (pic.y, pic.u, pic.v):
            if plane is not None:
                plane >>= self.shift
                plane <<= self.shift
        return pic

    def close(self):
        self.dec.flush()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m avbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--workers", type=int, default=1)
    args = p.parse_args(argv)
    from .run import run_cell
    from .spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    bpc = spec.config(cell)["bpc"]
    res = run_cell(spec, cell, args.seed, args.seconds, False, device="cpu",
                   make_decoder=lambda s, d: ControlDecoder(s, bpc),
                   workers=args.workers)
    print(json.dumps({"control": True, "workload": cell["name"],
                      "seed": args.seed, "correct": res["correct"],
                      "checks": res["checks"],
                      "pictures": res["facts"]["pictures"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
