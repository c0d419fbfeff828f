"""Super-resolution horizontal upscale helpers.

Behavior parity: src/decode.rs:4644 get_upscale_x0 (the resize filter itself
is in ops.mc.resize). Division truncates toward zero (C/Rust semantics).
"""


def c_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def get_upscale_x0(in_w: int, out_w: int, step: int) -> int:
    err = out_w * step - (in_w << 14)
    x0 = c_div(-((out_w - in_w) << 13) + (out_w >> 1), out_w) + 128 - c_div(err, 2)
    return x0 & 0x3FFF
