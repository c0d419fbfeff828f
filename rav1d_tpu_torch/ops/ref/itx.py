"""Inverse transforms: exact-integer AV1 inverse DCT/ADST/identity/WHT.

Behavior parity: src/itx.rs (inv_txfm_add_rust 2-D driver) and src/itx_1d.rs
(1-D kernels). All 1-D kernels are written VECTORIZED: `c` is an int64
ndarray of shape (N, lanes) and every statement operates on whole lane
vectors — the same dataflow runs under numpy here and under jax.numpy in the
TPU build (ops/itx.py).

Coefficient input layout matches decode_coefs: coeff[x*sh + y] (column-major
with sh = min(h,32)), int32, consumed (zeroed) by the call like the
reference.
"""

from __future__ import annotations

import numpy as np

from ...syntax.levels import (
    ADST_ADST,
    ADST_DCT,
    ADST_FLIPADST,
    DCT_ADST,
    DCT_DCT,
    DCT_FLIPADST,
    FLIPADST_ADST,
    FLIPADST_DCT,
    FLIPADST_FLIPADST,
    H_ADST,
    H_DCT,
    H_FLIPADST,
    IDTX,
    V_ADST,
    V_DCT,
    V_FLIPADST,
    WHT_WHT,
)


def _clip(v, mn, mx):
    # method dispatch keeps these kernels generic over numpy and jax arrays
    return v.clip(mn, mx)


def _snap(v):
    """Snapshot a lane before the in-place butterfly overwrites it: a real
    copy for numpy's mutable arrays, the value itself for immutable jax
    arrays (where .copy() would lower to a copy primitive Pallas/Mosaic
    has no rule for)."""
    return v.copy() if isinstance(v, np.ndarray) else v


# -- 1-D kernels -----------------------------------------------------------
# Each takes c: int64 array (N, L); operates in place along axis 0.


def _dct4(c, mn, mx, tx64=False):
    in0, in1 = c[0], c[1]
    if tx64:
        t0 = t1 = (in0 * 181 + 128) >> 8
        t2 = (in1 * 1567 + 2048) >> 12
        t3 = (in1 * 3784 + 2048) >> 12
    else:
        in2, in3 = c[2], c[3]
        t0 = ((in0 + in2) * 181 + 128) >> 8
        t1 = ((in0 - in2) * 181 + 128) >> 8
        t2 = ((in1 * 1567 - in3 * (3784 - 4096) + 2048) >> 12) - in3
        t3 = ((in1 * (3784 - 4096) + in3 * 1567 + 2048) >> 12) + in1
    c[0] = _clip(t0 + t3, mn, mx)
    c[1] = _clip(t1 + t2, mn, mx)
    c[2] = _clip(t1 - t2, mn, mx)
    c[3] = _clip(t0 - t3, mn, mx)


def _dct8(c, mn, mx, tx64=False):
    _dct4(c[::2], mn, mx, tx64)
    in1, in3 = c[1], c[3]
    if tx64:
        t4a = (in1 * 799 + 2048) >> 12
        t5a = (in3 * -2276 + 2048) >> 12
        t6a = (in3 * 3406 + 2048) >> 12
        t7a = (in1 * 4017 + 2048) >> 12
    else:
        in5, in7 = c[5], c[7]
        t4a = ((in1 * 799 - in7 * (4017 - 4096) + 2048) >> 12) - in7
        t5a = (in5 * 1703 - in3 * 1138 + 1024) >> 11
        t6a = (in5 * 1138 + in3 * 1703 + 1024) >> 11
        t7a = ((in1 * (4017 - 4096) + in7 * 799 + 2048) >> 12) + in1
    t4 = _clip(t4a + t5a, mn, mx)
    t5a = _clip(t4a - t5a, mn, mx)
    t7 = _clip(t7a + t6a, mn, mx)
    t6a = _clip(t7a - t6a, mn, mx)
    t5 = ((t6a - t5a) * 181 + 128) >> 8
    t6 = ((t6a + t5a) * 181 + 128) >> 8
    t0, t1, t2, t3 = _snap(c[0]), _snap(c[2]), _snap(c[4]), _snap(c[6])
    c[0] = _clip(t0 + t7, mn, mx)
    c[1] = _clip(t1 + t6, mn, mx)
    c[2] = _clip(t2 + t5, mn, mx)
    c[3] = _clip(t3 + t4, mn, mx)
    c[4] = _clip(t3 - t4, mn, mx)
    c[5] = _clip(t2 - t5, mn, mx)
    c[6] = _clip(t1 - t6, mn, mx)
    c[7] = _clip(t0 - t7, mn, mx)


def _dct16(c, mn, mx, tx64=False):
    _dct8(c[::2], mn, mx, tx64)
    in1, in3, in5, in7 = c[1], c[3], c[5], c[7]
    if tx64:
        t8a = (in1 * 401 + 2048) >> 12
        t9a = (in7 * -2598 + 2048) >> 12
        t10a = (in5 * 1931 + 2048) >> 12
        t11a = (in3 * -1189 + 2048) >> 12
        t12a = (in3 * 3920 + 2048) >> 12
        t13a = (in5 * 3612 + 2048) >> 12
        t14a = (in7 * 3166 + 2048) >> 12
        t15a = (in1 * 4076 + 2048) >> 12
    else:
        in9, in11, in13, in15 = c[9], c[11], c[13], c[15]
        t8a = ((in1 * 401 - in15 * (4076 - 4096) + 2048) >> 12) - in15
        t9a = (in9 * 1583 - in7 * 1299 + 1024) >> 11
        t10a = ((in5 * 1931 - in11 * (3612 - 4096) + 2048) >> 12) - in11
        t11a = ((in13 * (3920 - 4096) - in3 * 1189 + 2048) >> 12) + in13
        t12a = ((in13 * 1189 + in3 * (3920 - 4096) + 2048) >> 12) + in3
        t13a = ((in5 * (3612 - 4096) + in11 * 1931 + 2048) >> 12) + in5
        t14a = (in9 * 1299 + in7 * 1583 + 1024) >> 11
        t15a = ((in1 * (4076 - 4096) + in15 * 401 + 2048) >> 12) + in1
    t8 = _clip(t8a + t9a, mn, mx)
    t9 = _clip(t8a - t9a, mn, mx)
    t10 = _clip(t11a - t10a, mn, mx)
    t11 = _clip(t11a + t10a, mn, mx)
    t12 = _clip(t12a + t13a, mn, mx)
    t13 = _clip(t12a - t13a, mn, mx)
    t14 = _clip(t15a - t14a, mn, mx)
    t15 = _clip(t15a + t14a, mn, mx)
    t9a = ((t14 * 1567 - t9 * (3784 - 4096) + 2048) >> 12) - t9
    t14a = ((t14 * (3784 - 4096) + t9 * 1567 + 2048) >> 12) + t14
    t10a = ((-(t13 * (3784 - 4096) + t10 * 1567) + 2048) >> 12) - t13
    t13a = ((t13 * 1567 - t10 * (3784 - 4096) + 2048) >> 12) - t10
    t8a = _clip(t8 + t11, mn, mx)
    t9 = _clip(t9a + t10a, mn, mx)
    t10 = _clip(t9a - t10a, mn, mx)
    t11a = _clip(t8 - t11, mn, mx)
    t12a = _clip(t15 - t12, mn, mx)
    t13_ = _clip(t14a - t13a, mn, mx)
    t14 = _clip(t14a + t13a, mn, mx)
    t15a = _clip(t15 + t12, mn, mx)
    t10a = ((t13_ - t10) * 181 + 128) >> 8
    t13a = ((t13_ + t10) * 181 + 128) >> 8
    t11 = ((t12a - t11a) * 181 + 128) >> 8
    t12 = ((t12a + t11a) * 181 + 128) >> 8
    t0, t1, t2, t3 = _snap(c[0]), _snap(c[2]), _snap(c[4]), _snap(c[6])
    t4, t5, t6, t7 = _snap(c[8]), _snap(c[10]), _snap(c[12]), _snap(c[14])
    c[0] = _clip(t0 + t15a, mn, mx)
    c[1] = _clip(t1 + t14, mn, mx)
    c[2] = _clip(t2 + t13a, mn, mx)
    c[3] = _clip(t3 + t12, mn, mx)
    c[4] = _clip(t4 + t11, mn, mx)
    c[5] = _clip(t5 + t10a, mn, mx)
    c[6] = _clip(t6 + t9, mn, mx)
    c[7] = _clip(t7 + t8a, mn, mx)
    c[8] = _clip(t7 - t8a, mn, mx)
    c[9] = _clip(t6 - t9, mn, mx)
    c[10] = _clip(t5 - t10a, mn, mx)
    c[11] = _clip(t4 - t11, mn, mx)
    c[12] = _clip(t3 - t12, mn, mx)
    c[13] = _clip(t2 - t13a, mn, mx)
    c[14] = _clip(t1 - t14, mn, mx)
    c[15] = _clip(t0 - t15a, mn, mx)


def _dct32(c, mn, mx, tx64=False):
    _dct16(c[::2], mn, mx, tx64)
    in1, in3, in5, in7 = c[1], c[3], c[5], c[7]
    in9, in11, in13, in15 = c[9], c[11], c[13], c[15]
    if tx64:
        t16a = (in1 * 201 + 2048) >> 12
        t17a = (in15 * -2751 + 2048) >> 12
        t18a = (in9 * 1751 + 2048) >> 12
        t19a = (in7 * -1380 + 2048) >> 12
        t20a = (in5 * 995 + 2048) >> 12
        t21a = (in11 * -2106 + 2048) >> 12
        t22a = (in13 * 2440 + 2048) >> 12
        t23a = (in3 * -601 + 2048) >> 12
        t24a = (in3 * 4052 + 2048) >> 12
        t25a = (in13 * 3290 + 2048) >> 12
        t26a = (in11 * 3513 + 2048) >> 12
        t27a = (in5 * 3973 + 2048) >> 12
        t28a = (in7 * 3857 + 2048) >> 12
        t29a = (in9 * 3703 + 2048) >> 12
        t30a = (in15 * 3035 + 2048) >> 12
        t31a = (in1 * 4091 + 2048) >> 12
    else:
        in17, in19, in21, in23 = c[17], c[19], c[21], c[23]
        in25, in27, in29, in31 = c[25], c[27], c[29], c[31]
        t16a = ((in1 * 201 - in31 * (4091 - 4096) + 2048) >> 12) - in31
        t17a = ((in17 * (3035 - 4096) - in15 * 2751 + 2048) >> 12) + in17
        t18a = ((in9 * 1751 - in23 * (3703 - 4096) + 2048) >> 12) - in23
        t19a = ((in25 * (3857 - 4096) - in7 * 1380 + 2048) >> 12) + in25
        t20a = ((in5 * 995 - in27 * (3973 - 4096) + 2048) >> 12) - in27
        t21a = ((in21 * (3513 - 4096) - in11 * 2106 + 2048) >> 12) + in21
        t22a = (in13 * 1220 - in19 * 1645 + 1024) >> 11
        t23a = ((in29 * (4052 - 4096) - in3 * 601 + 2048) >> 12) + in29
        t24a = ((in29 * 601 + in3 * (4052 - 4096) + 2048) >> 12) + in3
        t25a = (in13 * 1645 + in19 * 1220 + 1024) >> 11
        t26a = ((in21 * 2106 + in11 * (3513 - 4096) + 2048) >> 12) + in11
        t27a = ((in5 * (3973 - 4096) + in27 * 995 + 2048) >> 12) + in5
        t28a = ((in25 * 1380 + in7 * (3857 - 4096) + 2048) >> 12) + in7
        t29a = ((in9 * (3703 - 4096) + in23 * 1751 + 2048) >> 12) + in9
        t30a = ((in17 * 2751 + in15 * (3035 - 4096) + 2048) >> 12) + in15
        t31a = ((in1 * (4091 - 4096) + in31 * 201 + 2048) >> 12) + in1
    t16 = _clip(t16a + t17a, mn, mx)
    t17 = _clip(t16a - t17a, mn, mx)
    t18 = _clip(t19a - t18a, mn, mx)
    t19 = _clip(t19a + t18a, mn, mx)
    t20 = _clip(t20a + t21a, mn, mx)
    t21 = _clip(t20a - t21a, mn, mx)
    t22 = _clip(t23a - t22a, mn, mx)
    t23 = _clip(t23a + t22a, mn, mx)
    t24 = _clip(t24a + t25a, mn, mx)
    t25 = _clip(t24a - t25a, mn, mx)
    t26 = _clip(t27a - t26a, mn, mx)
    t27 = _clip(t27a + t26a, mn, mx)
    t28 = _clip(t28a + t29a, mn, mx)
    t29 = _clip(t28a - t29a, mn, mx)
    t30 = _clip(t31a - t30a, mn, mx)
    t31 = _clip(t31a + t30a, mn, mx)
    t17a = ((t30 * 799 - t17 * (4017 - 4096) + 2048) >> 12) - t17
    t30a = ((t30 * (4017 - 4096) + t17 * 799 + 2048) >> 12) + t30
    t18a = ((-(t29 * (4017 - 4096) + t18 * 799) + 2048) >> 12) - t29
    t29a = ((t29 * 799 - t18 * (4017 - 4096) + 2048) >> 12) - t18
    t21a = (t26 * 1703 - t21 * 1138 + 1024) >> 11
    t26a = (t26 * 1138 + t21 * 1703 + 1024) >> 11
    t22a = (-(t25 * 1138 + t22 * 1703) + 1024) >> 11
    t25a = (t25 * 1703 - t22 * 1138 + 1024) >> 11
    t16a_ = _clip(t16 + t19, mn, mx)
    t17_ = _clip(t17a + t18a, mn, mx)
    t18_ = _clip(t17a - t18a, mn, mx)
    t19a = _clip(t16 - t19, mn, mx)
    t20a_ = _clip(t23 - t20, mn, mx)
    t21_ = _clip(t22a - t21a, mn, mx)
    t22_ = _clip(t22a + t21a, mn, mx)
    t23a = _clip(t23 + t20, mn, mx)
    t24a_ = _clip(t24 + t27, mn, mx)
    t25_ = _clip(t25a + t26a, mn, mx)
    t26_ = _clip(t25a - t26a, mn, mx)
    t27a = _clip(t24 - t27, mn, mx)
    t28a_ = _clip(t31 - t28, mn, mx)
    t29_ = _clip(t30a - t29a, mn, mx)
    t30_ = _clip(t30a + t29a, mn, mx)
    t31a = _clip(t31 + t28, mn, mx)
    t18a_ = ((t29_ * 1567 - t18_ * (3784 - 4096) + 2048) >> 12) - t18_
    t29a_ = ((t29_ * (3784 - 4096) + t18_ * 1567 + 2048) >> 12) + t29_
    t19_ = ((t28a_ * 1567 - t19a * (3784 - 4096) + 2048) >> 12) - t19a
    t28_ = ((t28a_ * (3784 - 4096) + t19a * 1567 + 2048) >> 12) + t28a_
    t20_ = ((-(t27a * (3784 - 4096) + t20a_ * 1567) + 2048) >> 12) - t27a
    t27_ = ((t27a * 1567 - t20a_ * (3784 - 4096) + 2048) >> 12) - t20a_
    t21a_ = ((-(t26_ * (3784 - 4096) + t21_ * 1567) + 2048) >> 12) - t26_
    t26a_ = ((t26_ * 1567 - t21_ * (3784 - 4096) + 2048) >> 12) - t21_
    t16_ = _clip(t16a_ + t23a, mn, mx)
    t17a_ = _clip(t17_ + t22_, mn, mx)
    t18__ = _clip(t18a_ + t21a_, mn, mx)
    t19a_ = _clip(t19_ + t20_, mn, mx)
    t20a__ = _clip(t19_ - t20_, mn, mx)
    t21__ = _clip(t18a_ - t21a_, mn, mx)
    t22a_ = _clip(t17_ - t22_, mn, mx)
    t23_ = _clip(t16a_ - t23a, mn, mx)
    t24_ = _clip(t31a - t24a_, mn, mx)
    t25a_ = _clip(t30_ - t25_, mn, mx)
    t26__ = _clip(t29a_ - t26a_, mn, mx)
    t27a_ = _clip(t28_ - t27_, mn, mx)
    t28a__ = _clip(t28_ + t27_, mn, mx)
    t29__ = _clip(t29a_ + t26a_, mn, mx)
    t30a_ = _clip(t30_ + t25_, mn, mx)
    t31_ = _clip(t31a + t24a_, mn, mx)
    t20__ = ((t27a_ - t20a__) * 181 + 128) >> 8
    t27__ = ((t27a_ + t20a__) * 181 + 128) >> 8
    t21a__ = ((t26__ - t21__) * 181 + 128) >> 8
    t26a__ = ((t26__ + t21__) * 181 + 128) >> 8
    t22__ = ((t25a_ - t22a_) * 181 + 128) >> 8
    t25__ = ((t25a_ + t22a_) * 181 + 128) >> 8
    t23a_ = ((t24_ - t23_) * 181 + 128) >> 8
    t24a__ = ((t24_ + t23_) * 181 + 128) >> 8
    t = [_snap(c[2 * i]) for i in range(16)]
    add = [
        t31_, t30a_, t29__, t28a__, t27__, t26a__, t25__, t24a__,
        t23a_, t22__, t21a__, t20__, t19a_, t18__, t17a_, t16_,
    ]
    for i in range(16):
        c[i] = _clip(t[i] + add[i], mn, mx)
        c[31 - i] = _clip(t[i] - add[i], mn, mx)


def _dct64(c, mn, mx):
    _dct32(c[::2], mn, mx, tx64=True)
    (
        in1, in3, in5, in7, in9, in11, in13, in15,
        in17, in19, in21, in23, in25, in27, in29, in31,
    ) = [c[k] for k in range(1, 32, 2)]
    t32a = (in1 * 101 + 2048) >> 12
    t33a = (in31 * -2824 + 2048) >> 12
    t34a = (in17 * 1660 + 2048) >> 12
    t35a = (in15 * -1474 + 2048) >> 12
    t36a = (in9 * 897 + 2048) >> 12
    t37a = (in23 * -2191 + 2048) >> 12
    t38a = (in25 * 2359 + 2048) >> 12
    t39a = (in7 * -700 + 2048) >> 12
    t40a = (in5 * 501 + 2048) >> 12
    t41a = (in27 * -2520 + 2048) >> 12
    t42a = (in21 * 2019 + 2048) >> 12
    t43a = (in11 * -1092 + 2048) >> 12
    t44a = (in13 * 1285 + 2048) >> 12
    t45a = (in19 * -1842 + 2048) >> 12
    t46a = (in29 * 2675 + 2048) >> 12
    t47a = (in3 * -301 + 2048) >> 12
    t48a = (in3 * 4085 + 2048) >> 12
    t49a = (in29 * 3102 + 2048) >> 12
    t50a = (in19 * 3659 + 2048) >> 12
    t51a = (in13 * 3889 + 2048) >> 12
    t52a = (in11 * 3948 + 2048) >> 12
    t53a = (in21 * 3564 + 2048) >> 12
    t54a = (in27 * 3229 + 2048) >> 12
    t55a = (in5 * 4065 + 2048) >> 12
    t56a = (in7 * 4036 + 2048) >> 12
    t57a = (in25 * 3349 + 2048) >> 12
    t58a = (in23 * 3461 + 2048) >> 12
    t59a = (in9 * 3996 + 2048) >> 12
    t60a = (in15 * 3822 + 2048) >> 12
    t61a = (in17 * 3745 + 2048) >> 12
    t62a = (in31 * 2967 + 2048) >> 12
    t63a = (in1 * 4095 + 2048) >> 12
    t32 = _clip(t32a + t33a, mn, mx)
    t33 = _clip(t32a - t33a, mn, mx)
    t34 = _clip(t35a - t34a, mn, mx)
    t35 = _clip(t35a + t34a, mn, mx)
    t36 = _clip(t36a + t37a, mn, mx)
    t37 = _clip(t36a - t37a, mn, mx)
    t38 = _clip(t39a - t38a, mn, mx)
    t39 = _clip(t39a + t38a, mn, mx)
    t40 = _clip(t40a + t41a, mn, mx)
    t41 = _clip(t40a - t41a, mn, mx)
    t42 = _clip(t43a - t42a, mn, mx)
    t43 = _clip(t43a + t42a, mn, mx)
    t44 = _clip(t44a + t45a, mn, mx)
    t45 = _clip(t44a - t45a, mn, mx)
    t46 = _clip(t47a - t46a, mn, mx)
    t47 = _clip(t47a + t46a, mn, mx)
    t48 = _clip(t48a + t49a, mn, mx)
    t49 = _clip(t48a - t49a, mn, mx)
    t50 = _clip(t51a - t50a, mn, mx)
    t51 = _clip(t51a + t50a, mn, mx)
    t52 = _clip(t52a + t53a, mn, mx)
    t53 = _clip(t52a - t53a, mn, mx)
    t54 = _clip(t55a - t54a, mn, mx)
    t55 = _clip(t55a + t54a, mn, mx)
    t56 = _clip(t56a + t57a, mn, mx)
    t57 = _clip(t56a - t57a, mn, mx)
    t58 = _clip(t59a - t58a, mn, mx)
    t59 = _clip(t59a + t58a, mn, mx)
    t60 = _clip(t60a + t61a, mn, mx)
    t61 = _clip(t60a - t61a, mn, mx)
    t62 = _clip(t63a - t62a, mn, mx)
    t63 = _clip(t63a + t62a, mn, mx)
    t33a = ((t33 * (4096 - 4076) + t62 * 401 + 2048) >> 12) - t33
    t34a = ((t34 * -401 + t61 * (4096 - 4076) + 2048) >> 12) - t61
    t37a = (t37 * -1299 + t58 * 1583 + 1024) >> 11
    t38a = (t38 * -1583 + t57 * -1299 + 1024) >> 11
    t41a = ((t41 * (4096 - 3612) + t54 * 1931 + 2048) >> 12) - t41
    t42a = ((t42 * -1931 + t53 * (4096 - 3612) + 2048) >> 12) - t53
    t45a = ((t45 * -1189 + t50 * (3920 - 4096) + 2048) >> 12) + t50
    t46a = ((t46 * (4096 - 3920) + t49 * -1189 + 2048) >> 12) - t46
    t49a = ((t46 * -1189 + t49 * (3920 - 4096) + 2048) >> 12) + t49
    t50a = ((t45 * (3920 - 4096) + t50 * 1189 + 2048) >> 12) + t45
    t53a = ((t42 * (4096 - 3612) + t53 * 1931 + 2048) >> 12) - t42
    t54a = ((t41 * 1931 + t54 * (3612 - 4096) + 2048) >> 12) + t54
    t57a = (t38 * -1299 + t57 * 1583 + 1024) >> 11
    t58a = (t37 * 1583 + t58 * 1299 + 1024) >> 11
    t61a = ((t34 * (4096 - 4076) + t61 * 401 + 2048) >> 12) - t34
    t62a = ((t33 * 401 + t62 * (4076 - 4096) + 2048) >> 12) + t62
    t32a_ = _clip(t32 + t35, mn, mx)
    t33_ = _clip(t33a + t34a, mn, mx)
    t34_ = _clip(t33a - t34a, mn, mx)
    t35a_ = _clip(t32 - t35, mn, mx)
    t36a_ = _clip(t39 - t36, mn, mx)
    t37_ = _clip(t38a - t37a, mn, mx)
    t38_ = _clip(t38a + t37a, mn, mx)
    t39a_ = _clip(t39 + t36, mn, mx)
    t40a_ = _clip(t40 + t43, mn, mx)
    t41_ = _clip(t41a + t42a, mn, mx)
    t42_ = _clip(t41a - t42a, mn, mx)
    t43a_ = _clip(t40 - t43, mn, mx)
    t44a_ = _clip(t47 - t44, mn, mx)
    t45_ = _clip(t46a - t45a, mn, mx)
    t46_ = _clip(t46a + t45a, mn, mx)
    t47a_ = _clip(t47 + t44, mn, mx)
    t48a_ = _clip(t48 + t51, mn, mx)
    t49_ = _clip(t49a + t50a, mn, mx)
    t50_ = _clip(t49a - t50a, mn, mx)
    t51a_ = _clip(t48 - t51, mn, mx)
    t52a_ = _clip(t55 - t52, mn, mx)
    t53_ = _clip(t54a - t53a, mn, mx)
    t54_ = _clip(t54a + t53a, mn, mx)
    t55a_ = _clip(t55 + t52, mn, mx)
    t56a_ = _clip(t56 + t59, mn, mx)
    t57_ = _clip(t57a + t58a, mn, mx)
    t58_ = _clip(t57a - t58a, mn, mx)
    t59a_ = _clip(t56 - t59, mn, mx)
    t60a_ = _clip(t63 - t60, mn, mx)
    t61_ = _clip(t62a - t61a, mn, mx)
    t62_ = _clip(t62a + t61a, mn, mx)
    t63a_ = _clip(t63 + t60, mn, mx)
    t34a_2 = ((t34_ * (4096 - 4017) + t61_ * 799 + 2048) >> 12) - t34_
    t35_2 = ((t35a_ * (4096 - 4017) + t60a_ * 799 + 2048) >> 12) - t35a_
    t36_2 = ((t36a_ * -799 + t59a_ * (4096 - 4017) + 2048) >> 12) - t59a_
    t37a_2 = ((t37_ * -799 + t58_ * (4096 - 4017) + 2048) >> 12) - t58_
    t42a_2 = (t42_ * -1138 + t53_ * 1703 + 1024) >> 11
    t43_2 = (t43a_ * -1138 + t52a_ * 1703 + 1024) >> 11
    t44_2 = (t44a_ * -1703 + t51a_ * -1138 + 1024) >> 11
    t45a_2 = (t45_ * -1703 + t50_ * -1138 + 1024) >> 11
    t50a_2 = (t45_ * -1138 + t50_ * 1703 + 1024) >> 11
    t51_2 = (t44a_ * -1138 + t51a_ * 1703 + 1024) >> 11
    t52_2 = (t43a_ * 1703 + t52a_ * 1138 + 1024) >> 11
    t53a_2 = (t42_ * 1703 + t53_ * 1138 + 1024) >> 11
    t58a_2 = ((t37_ * (4096 - 4017) + t58_ * 799 + 2048) >> 12) - t37_
    t59_2 = ((t36a_ * (4096 - 4017) + t59a_ * 799 + 2048) >> 12) - t36a_
    t60_2 = ((t35a_ * 799 + t60a_ * (4017 - 4096) + 2048) >> 12) + t60a_
    t61a_2 = ((t34_ * 799 + t61_ * (4017 - 4096) + 2048) >> 12) + t61_
    t32_ = _clip(t32a_ + t39a_, mn, mx)
    t33a_2 = _clip(t33_ + t38_, mn, mx)
    t34__ = _clip(t34a_2 + t37a_2, mn, mx)
    t35a__ = _clip(t35_2 + t36_2, mn, mx)
    t36a__ = _clip(t35_2 - t36_2, mn, mx)
    t37__ = _clip(t34a_2 - t37a_2, mn, mx)
    t38a_2 = _clip(t33_ - t38_, mn, mx)
    t39_ = _clip(t32a_ - t39a_, mn, mx)
    t40_ = _clip(t47a_ - t40a_, mn, mx)
    t41a_2 = _clip(t46_ - t41_, mn, mx)
    t42__ = _clip(t45a_2 - t42a_2, mn, mx)
    t43a_2 = _clip(t44_2 - t43_2, mn, mx)
    t44a_2 = _clip(t44_2 + t43_2, mn, mx)
    t45__ = _clip(t45a_2 + t42a_2, mn, mx)
    t46a_2 = _clip(t46_ + t41_, mn, mx)
    t47_ = _clip(t47a_ + t40a_, mn, mx)
    t48_ = _clip(t48a_ + t55a_, mn, mx)
    t49a_2 = _clip(t49_ + t54_, mn, mx)
    t50__ = _clip(t50a_2 + t53a_2, mn, mx)
    t51a_2 = _clip(t51_2 + t52_2, mn, mx)
    t52a_2 = _clip(t51_2 - t52_2, mn, mx)
    t53__ = _clip(t50a_2 - t53a_2, mn, mx)
    t54a_2 = _clip(t49_ - t54_, mn, mx)
    t55_ = _clip(t48a_ - t55a_, mn, mx)
    t56_ = _clip(t63a_ - t56a_, mn, mx)
    t57a_2 = _clip(t62_ - t57_, mn, mx)
    t58__ = _clip(t61a_2 - t58a_2, mn, mx)
    t59a_2 = _clip(t60_2 - t59_2, mn, mx)
    t60a_2 = _clip(t60_2 + t59_2, mn, mx)
    t61__ = _clip(t61a_2 + t58a_2, mn, mx)
    t62a_2 = _clip(t62_ + t57_, mn, mx)
    t63_ = _clip(t63a_ + t56a_, mn, mx)
    t36__ = ((t36a__ * (4096 - 3784) + t59a_2 * 1567 + 2048) >> 12) - t36a__
    t37a_3 = ((t37__ * (4096 - 3784) + t58__ * 1567 + 2048) >> 12) - t37__
    t38__ = ((t38a_2 * (4096 - 3784) + t57a_2 * 1567 + 2048) >> 12) - t38a_2
    t39a_2 = ((t39_ * (4096 - 3784) + t56_ * 1567 + 2048) >> 12) - t39_
    t40a_2 = ((t40_ * -1567 + t55_ * (4096 - 3784) + 2048) >> 12) - t55_
    t41__ = ((t41a_2 * -1567 + t54a_2 * (4096 - 3784) + 2048) >> 12) - t54a_2
    t42a_3 = ((t42__ * -1567 + t53__ * (4096 - 3784) + 2048) >> 12) - t53__
    t43__ = ((t43a_2 * -1567 + t52a_2 * (4096 - 3784) + 2048) >> 12) - t52a_2
    t52__ = ((t43a_2 * (4096 - 3784) + t52a_2 * 1567 + 2048) >> 12) - t43a_2
    t53a_3 = ((t42__ * (4096 - 3784) + t53__ * 1567 + 2048) >> 12) - t42__
    t54__ = ((t41a_2 * (4096 - 3784) + t54a_2 * 1567 + 2048) >> 12) - t41a_2
    t55a_2 = ((t40_ * (4096 - 3784) + t55_ * 1567 + 2048) >> 12) - t40_
    t56a_2 = ((t39_ * 1567 + t56_ * (3784 - 4096) + 2048) >> 12) + t56_
    t57__ = ((t38a_2 * 1567 + t57a_2 * (3784 - 4096) + 2048) >> 12) + t57a_2
    t58a_3 = ((t37__ * 1567 + t58__ * (3784 - 4096) + 2048) >> 12) + t58__
    t59__ = ((t36a__ * 1567 + t59a_2 * (3784 - 4096) + 2048) >> 12) + t59a_2
    t32a__ = _clip(t32_ + t47_, mn, mx)
    t33__ = _clip(t33a_2 + t46a_2, mn, mx)
    t34a_3 = _clip(t34__ + t45__, mn, mx)
    t35__ = _clip(t35a__ + t44a_2, mn, mx)
    t36a_3 = _clip(t36__ + t43__, mn, mx)
    t37___ = _clip(t37a_3 + t42a_3, mn, mx)
    t38a_3 = _clip(t38__ + t41__, mn, mx)
    t39__ = _clip(t39a_2 + t40a_2, mn, mx)
    t40__ = _clip(t39a_2 - t40a_2, mn, mx)
    t41a_3 = _clip(t38__ - t41__, mn, mx)
    t42___ = _clip(t37a_3 - t42a_3, mn, mx)
    t43a_3 = _clip(t36__ - t43__, mn, mx)
    t44__ = _clip(t35a__ - t44a_2, mn, mx)
    t45a_3 = _clip(t34__ - t45__, mn, mx)
    t46__ = _clip(t33a_2 - t46a_2, mn, mx)
    t47a_2 = _clip(t32_ - t47_, mn, mx)
    t48a_2 = _clip(t63_ - t48_, mn, mx)
    t49__ = _clip(t62a_2 - t49a_2, mn, mx)
    t50a_3 = _clip(t61__ - t50__, mn, mx)
    t51__ = _clip(t60a_2 - t51a_2, mn, mx)
    t52a_3 = _clip(t59__ - t52__, mn, mx)
    t53___ = _clip(t58a_3 - t53a_3, mn, mx)
    t54a_3 = _clip(t57__ - t54__, mn, mx)
    t55__ = _clip(t56a_2 - t55a_2, mn, mx)
    t56__ = _clip(t56a_2 + t55a_2, mn, mx)
    t57a_3 = _clip(t57__ + t54__, mn, mx)
    t58__2 = _clip(t58a_3 + t53a_3, mn, mx)
    t59a_3 = _clip(t59__ + t52__, mn, mx)
    t60__ = _clip(t60a_2 + t51a_2, mn, mx)
    t61a_3 = _clip(t61__ + t50__, mn, mx)
    t62__ = _clip(t62a_2 + t49a_2, mn, mx)
    t63a_2 = _clip(t63_ + t48_, mn, mx)
    t40a_3 = ((t55__ - t40__) * 181 + 128) >> 8
    t41__2 = ((t54a_3 - t41a_3) * 181 + 128) >> 8
    t42a_4 = ((t53___ - t42___) * 181 + 128) >> 8
    t43__2 = ((t52a_3 - t43a_3) * 181 + 128) >> 8
    t44a_3 = ((t51__ - t44__) * 181 + 128) >> 8
    t45__2 = ((t50a_3 - t45a_3) * 181 + 128) >> 8
    t46a_3 = ((t49__ - t46__) * 181 + 128) >> 8
    t47__ = ((t48a_2 - t47a_2) * 181 + 128) >> 8
    t48__ = ((t47a_2 + t48a_2) * 181 + 128) >> 8
    t49a_3 = ((t46__ + t49__) * 181 + 128) >> 8
    t50__2 = ((t45a_3 + t50a_3) * 181 + 128) >> 8
    t51a_3 = ((t44__ + t51__) * 181 + 128) >> 8
    t52__2 = ((t43a_3 + t52a_3) * 181 + 128) >> 8
    t53a_4 = ((t42___ + t53___) * 181 + 128) >> 8
    t54__2 = ((t41a_3 + t54a_3) * 181 + 128) >> 8
    t55a_3 = ((t40__ + t55__) * 181 + 128) >> 8
    t = [_snap(c[2 * k]) for k in range(32)]
    add = [
        t63a_2, t62__, t61a_3, t60__, t59a_3, t58__2, t57a_3, t56__,
        t55a_3, t54__2, t53a_4, t52__2, t51a_3, t50__2, t49a_3, t48__,
        t47__, t46a_3, t45__2, t44a_3, t43__2, t42a_4, t41__2, t40a_3,
        t39__, t38a_3, t37___, t36a_3, t35__, t34a_3, t33__, t32a__,
    ]
    for k in range(32):
        c[k] = _clip(t[k] + add[k], mn, mx)
        c[63 - k] = _clip(t[k] - add[k], mn, mx)


def _adst4_core(cin):
    in0, in1, in2, in3 = cin[0], cin[1], cin[2], cin[3]
    o0 = (
        (1321 * in0 + (3803 - 4096) * in2 + (2482 - 4096) * in3 + (3344 - 4096) * in1 + 2048)
        >> 12
    ) + in2 + in3 + in1
    o1 = (
        ((2482 - 4096) * in0 - 1321 * in2 - (3803 - 4096) * in3 + (3344 - 4096) * in1 + 2048)
        >> 12
    ) + in0 - in3 + in1
    o2 = (209 * (in0 - in2 + in3) + 128) >> 8
    o3 = (
        ((3803 - 4096) * in0 + (2482 - 4096) * in2 - 1321 * in3 - (3344 - 4096) * in1 + 2048)
        >> 12
    ) + in0 + in2 - in1
    return [o0, o1, o2, o3]


def _adst8_core(cin, mn, mx):
    in0, in1, in2, in3 = cin[0], cin[1], cin[2], cin[3]
    in4, in5, in6, in7 = cin[4], cin[5], cin[6], cin[7]
    t0a = (((4076 - 4096) * in7 + 401 * in0 + 2048) >> 12) + in7
    t1a = ((401 * in7 - (4076 - 4096) * in0 + 2048) >> 12) - in0
    t2a = (((3612 - 4096) * in5 + 1931 * in2 + 2048) >> 12) + in5
    t3a = ((1931 * in5 - (3612 - 4096) * in2 + 2048) >> 12) - in2
    t4a = (1299 * in3 + 1583 * in4 + 1024) >> 11
    t5a = (1583 * in3 - 1299 * in4 + 1024) >> 11
    t6a = ((1189 * in1 + (3920 - 4096) * in6 + 2048) >> 12) + in6
    t7a = (((3920 - 4096) * in1 - 1189 * in6 + 2048) >> 12) + in1
    t0 = _clip(t0a + t4a, mn, mx)
    t1 = _clip(t1a + t5a, mn, mx)
    t2 = _clip(t2a + t6a, mn, mx)
    t3 = _clip(t3a + t7a, mn, mx)
    t4 = _clip(t0a - t4a, mn, mx)
    t5 = _clip(t1a - t5a, mn, mx)
    t6 = _clip(t2a - t6a, mn, mx)
    t7 = _clip(t3a - t7a, mn, mx)
    t4a = (((3784 - 4096) * t4 + 1567 * t5 + 2048) >> 12) + t4
    t5a = ((1567 * t4 - (3784 - 4096) * t5 + 2048) >> 12) - t5
    t6a = (((3784 - 4096) * t7 - 1567 * t6 + 2048) >> 12) + t7
    t7a = ((1567 * t7 + (3784 - 4096) * t6 + 2048) >> 12) + t6
    out = [None] * 8
    out[0] = _clip(t0 + t2, mn, mx)
    out[7] = -_clip(t1 + t3, mn, mx)
    t2 = _clip(t0 - t2, mn, mx)
    t3 = _clip(t1 - t3, mn, mx)
    out[1] = -_clip(t4a + t6a, mn, mx)
    out[6] = _clip(t5a + t7a, mn, mx)
    t6 = _clip(t4a - t6a, mn, mx)
    t7 = _clip(t5a - t7a, mn, mx)
    out[3] = -(((t2 + t3) * 181 + 128) >> 8)
    out[4] = ((t2 - t3) * 181 + 128) >> 8
    out[2] = ((t6 + t7) * 181 + 128) >> 8
    out[5] = -(((t6 - t7) * 181 + 128) >> 8)
    return out


def _adst16_core(cin, mn, mx):
    (
        in0, in1, in2, in3, in4, in5, in6, in7,
        in8, in9, in10, in11, in12, in13, in14, in15,
    ) = [cin[k] for k in range(16)]
    t0 = ((in15 * (4091 - 4096) + in0 * 201 + 2048) >> 12) + in15
    t1 = ((in15 * 201 - in0 * (4091 - 4096) + 2048) >> 12) - in0
    t2 = ((in13 * (3973 - 4096) + in2 * 995 + 2048) >> 12) + in13
    t3 = ((in13 * 995 - in2 * (3973 - 4096) + 2048) >> 12) - in2
    t4 = ((in11 * (3703 - 4096) + in4 * 1751 + 2048) >> 12) + in11
    t5 = ((in11 * 1751 - in4 * (3703 - 4096) + 2048) >> 12) - in4
    t6 = (in9 * 1645 + in6 * 1220 + 1024) >> 11
    t7 = (in9 * 1220 - in6 * 1645 + 1024) >> 11
    t8 = ((in7 * 2751 + in8 * (3035 - 4096) + 2048) >> 12) + in8
    t9 = ((in7 * (3035 - 4096) - in8 * 2751 + 2048) >> 12) + in7
    t10 = ((in5 * 2106 + in10 * (3513 - 4096) + 2048) >> 12) + in10
    t11 = ((in5 * (3513 - 4096) - in10 * 2106 + 2048) >> 12) + in5
    t12 = ((in3 * 1380 + in12 * (3857 - 4096) + 2048) >> 12) + in12
    t13 = ((in3 * (3857 - 4096) - in12 * 1380 + 2048) >> 12) + in3
    t14 = ((in1 * 601 + in14 * (4052 - 4096) + 2048) >> 12) + in14
    t15 = ((in1 * (4052 - 4096) - in14 * 601 + 2048) >> 12) + in1
    t0a = _clip(t0 + t8, mn, mx)
    t1a = _clip(t1 + t9, mn, mx)
    t2a = _clip(t2 + t10, mn, mx)
    t3a = _clip(t3 + t11, mn, mx)
    t4a = _clip(t4 + t12, mn, mx)
    t5a = _clip(t5 + t13, mn, mx)
    t6a = _clip(t6 + t14, mn, mx)
    t7a = _clip(t7 + t15, mn, mx)
    t8a = _clip(t0 - t8, mn, mx)
    t9a = _clip(t1 - t9, mn, mx)
    t10a = _clip(t2 - t10, mn, mx)
    t11a = _clip(t3 - t11, mn, mx)
    t12a = _clip(t4 - t12, mn, mx)
    t13a = _clip(t5 - t13, mn, mx)
    t14a = _clip(t6 - t14, mn, mx)
    t15a = _clip(t7 - t15, mn, mx)
    t8 = ((t8a * (4017 - 4096) + t9a * 799 + 2048) >> 12) + t8a
    t9 = ((t8a * 799 - t9a * (4017 - 4096) + 2048) >> 12) - t9a
    t10 = ((t10a * 2276 + t11a * (3406 - 4096) + 2048) >> 12) + t11a
    t11 = ((t10a * (3406 - 4096) - t11a * 2276 + 2048) >> 12) + t10a
    t12 = ((t13a * (4017 - 4096) - t12a * 799 + 2048) >> 12) + t13a
    t13 = ((t13a * 799 + t12a * (4017 - 4096) + 2048) >> 12) + t12a
    t14 = ((t15a * 2276 - t14a * (3406 - 4096) + 2048) >> 12) - t14a
    t15 = ((t15a * (3406 - 4096) + t14a * 2276 + 2048) >> 12) + t15a
    t0 = _clip(t0a + t4a, mn, mx)
    t1 = _clip(t1a + t5a, mn, mx)
    t2 = _clip(t2a + t6a, mn, mx)
    t3 = _clip(t3a + t7a, mn, mx)
    t4 = _clip(t0a - t4a, mn, mx)
    t5 = _clip(t1a - t5a, mn, mx)
    t6 = _clip(t2a - t6a, mn, mx)
    t7 = _clip(t3a - t7a, mn, mx)
    t8a = _clip(t8 + t12, mn, mx)
    t9a = _clip(t9 + t13, mn, mx)
    t10a = _clip(t10 + t14, mn, mx)
    t11a = _clip(t11 + t15, mn, mx)
    t12a = _clip(t8 - t12, mn, mx)
    t13a = _clip(t9 - t13, mn, mx)
    t14a = _clip(t10 - t14, mn, mx)
    t15a = _clip(t11 - t15, mn, mx)
    t4a = ((t4 * (3784 - 4096) + t5 * 1567 + 2048) >> 12) + t4
    t5a = ((t4 * 1567 - t5 * (3784 - 4096) + 2048) >> 12) - t5
    t6a = ((t7 * (3784 - 4096) - t6 * 1567 + 2048) >> 12) + t7
    t7a = ((t7 * 1567 + t6 * (3784 - 4096) + 2048) >> 12) + t6
    t12 = ((t12a * (3784 - 4096) + t13a * 1567 + 2048) >> 12) + t12a
    t13 = ((t12a * 1567 - t13a * (3784 - 4096) + 2048) >> 12) - t13a
    t14 = ((t15a * (3784 - 4096) - t14a * 1567 + 2048) >> 12) + t15a
    t15 = ((t15a * 1567 + t14a * (3784 - 4096) + 2048) >> 12) + t14a
    out = [None] * 16
    out[0] = _clip(t0 + t2, mn, mx)
    out[15] = -_clip(t1 + t3, mn, mx)
    t2a = _clip(t0 - t2, mn, mx)
    t3a = _clip(t1 - t3, mn, mx)
    out[3] = -_clip(t4a + t6a, mn, mx)
    out[12] = _clip(t5a + t7a, mn, mx)
    t6 = _clip(t4a - t6a, mn, mx)
    t7 = _clip(t5a - t7a, mn, mx)
    out[1] = -_clip(t8a + t10a, mn, mx)
    out[14] = _clip(t9a + t11a, mn, mx)
    t10 = _clip(t8a - t10a, mn, mx)
    t11 = _clip(t9a - t11a, mn, mx)
    out[2] = _clip(t12 + t14, mn, mx)
    out[13] = -_clip(t13 + t15, mn, mx)
    t14a = _clip(t12 - t14, mn, mx)
    t15a = _clip(t13 - t15, mn, mx)
    out[7] = -(((t2a + t3a) * 181 + 128) >> 8)
    out[8] = ((t2a - t3a) * 181 + 128) >> 8
    out[4] = ((t6 + t7) * 181 + 128) >> 8
    out[11] = -(((t6 - t7) * 181 + 128) >> 8)
    out[6] = ((t10 + t11) * 181 + 128) >> 8
    out[9] = -(((t10 - t11) * 181 + 128) >> 8)
    out[5] = -(((t14a + t15a) * 181 + 128) >> 8)
    out[10] = ((t14a - t15a) * 181 + 128) >> 8
    return out


def _make_adst(core, n, flip):
    if n == 4:
        def f(c, mn, mx):
            out = _adst4_core(c)
            for k in range(4):
                c[n - 1 - k if flip else k] = out[k]
    else:
        def f(c, mn, mx):
            out = core(c, mn, mx)
            for k in range(n):
                c[n - 1 - k if flip else k] = out[k]
    return f


def _identity4(c, mn, mx):
    c[:4] = c[:4] + ((c[:4] * 1697 + 2048) >> 12)


def _identity8(c, mn, mx):
    c[:8] *= 2


def _identity16(c, mn, mx):
    c[:16] = 2 * c[:16] + ((c[:16] * 1697 + 1024) >> 11)


def _identity32(c, mn, mx):
    c[:32] *= 4


def _wht4(c):
    in0, in1, in2, in3 = c[0], c[1], c[2], c[3]
    t0 = in0 + in1
    t2 = in2 - in3
    t4 = (t0 - t2) >> 1
    t3 = t4 - in3
    t1 = t4 - in1
    c[0] = t0 - t3
    c[1] = t3
    c[2] = t1
    c[3] = t2 + t1


_DCT = {4: _dct4, 8: _dct8, 16: _dct16, 32: _dct32, 64: _dct64}
_ADST = {
    4: _make_adst(None, 4, False),
    8: _make_adst(_adst8_core, 8, False),
    16: _make_adst(_adst16_core, 16, False),
}
_FLIPADST = {
    4: _make_adst(None, 4, True),
    8: _make_adst(_adst8_core, 8, True),
    16: _make_adst(_adst16_core, 16, True),
}
_IDENTITY = {4: _identity4, 8: _identity8, 16: _identity16, 32: _identity32}

# txtp → (horizontal 1d family, vertical 1d family). NOTE: the AV1 tx-type
# enum names are (vertical, horizontal), so mixed pairs swap here
# (src/itx_tmpl.c:203 maps DCT_ADST → inv_txfm_add_adst_dct).
_TXTP_1D = {
    DCT_DCT: ("dct", "dct"),
    ADST_DCT: ("dct", "adst"),
    DCT_ADST: ("adst", "dct"),
    ADST_ADST: ("adst", "adst"),
    FLIPADST_DCT: ("dct", "flipadst"),
    DCT_FLIPADST: ("flipadst", "dct"),
    FLIPADST_FLIPADST: ("flipadst", "flipadst"),
    ADST_FLIPADST: ("flipadst", "adst"),
    FLIPADST_ADST: ("adst", "flipadst"),
    IDTX: ("identity", "identity"),
    V_DCT: ("identity", "dct"),
    H_DCT: ("dct", "identity"),
    V_ADST: ("identity", "adst"),
    H_ADST: ("adst", "identity"),
    V_FLIPADST: ("identity", "flipadst"),
    H_FLIPADST: ("flipadst", "identity"),
}

_FAMILY = {"dct": _DCT, "adst": _ADST, "flipadst": _FLIPADST, "identity": _IDENTITY}

# per (w,h): final shift (src/itx.rs inv_txfm_fnNN instantiations)
_SHIFTS = {
    (4, 4): 0, (4, 8): 0, (4, 16): 1, (8, 4): 0, (8, 8): 1, (8, 16): 1,
    (8, 32): 2, (16, 4): 1, (16, 8): 1, (16, 16): 2, (16, 32): 1,
    (16, 64): 2, (32, 8): 2, (32, 16): 1, (32, 32): 2, (32, 64): 1,
    (64, 16): 2, (64, 32): 1, (64, 64): 2,
}


def inv_txfm_add(dst, coeff, eob, w, h, txtp, bpc):
    """Inverse-transform coeff and add into dst (h, w) uint8/16 view.

    dst: numpy view into the picture plane; coeff: int32 array (rc layout);
    consumed (zeroed). Parity: inv_txfm_add_rust (src/itx.rs:64).
    """
    if txtp == WHT_WHT:
        return _wht_add(dst, coeff, bpc)

    first_name, second_name = _TXTP_1D[txtp]
    has_dconly = 1 if txtp == DCT_DCT else 0
    shift = _SHIFTS[(w, h)]
    is_rect2 = w * 2 == h or h * 2 == w
    rnd = (1 << shift) >> 1
    pixel_max = (1 << bpc) - 1

    if eob < has_dconly:
        dc = int(coeff[0])
        coeff[0] = 0
        if is_rect2:
            dc = (dc * 181 + 128) >> 8
        dc = (dc * 181 + 128) >> 8
        dc = (dc + rnd) >> shift
        dc = (dc * 181 + 128 + 2048) >> 12
        dst[:, :] = np.clip(dst.astype(np.int32) + dc, 0, pixel_max).astype(dst.dtype)
        return

    sh = min(h, 32)
    sw = min(w, 32)
    if bpc == 8:
        row_clip_min = col_clip_min = -(1 << 15)
    else:
        bitdepth_max = (1 << bpc) - 1
        row_clip_min = (~bitdepth_max) << 7
        col_clip_min = (~bitdepth_max) << 5
    row_clip_max = ~row_clip_min
    col_clip_max = ~col_clip_min

    # gather into (sh, sw): tmp[y, x] = coeff[y + x*sh]
    cbuf = np.asarray(coeff[: sw * sh], dtype=np.int64).reshape(sw, sh).T.copy()
    if is_rect2:
        cbuf = (cbuf * 181 + 128) >> 8
    # first pass: transform each row (w-point horizontal); vectorized over rows
    tmp = np.zeros((h, w), dtype=np.int64)
    tmp[:sh, :sw] = cbuf
    first = _FAMILY[first_name][w]
    # operate on transposed view so axis 0 = transform points, lanes = rows
    ct = np.ascontiguousarray(tmp[:sh, :].T)  # (w, sh)
    first(ct, row_clip_min, row_clip_max)
    tmp[:sh, :] = ct.T
    coeff[: sw * sh] = 0
    tmp[:sh, :] = np.clip(tmp[:sh, :] + rnd >> shift, col_clip_min, col_clip_max)
    # second pass: transform each column (h-point vertical)
    second = _FAMILY[second_name][h]
    second(tmp, col_clip_min, col_clip_max)
    res = (tmp + 8) >> 4
    dst[:, :] = np.clip(dst.astype(np.int64) + res, 0, pixel_max).astype(dst.dtype)


def inv_txfm_add_batch(dst, ys, xs, cfs, eobs, w, h, txtp, bpc):
    """Batched inverse transform + add for N same-shape txblocks.

    dst: full picture plane; ys/xs: (N,) absolute pixel coords; cfs: (N, sw*sh)
    int32 coefficient rows; eobs: (N,). Blocks' destination regions are
    disjoint (inter residuals), so gather/add/scatter in one shot. The 1-D
    kernels are lane-vectorized, so N folds into the lane axis — this same
    dataflow is the TPU itx kernel (ops/tpu/itx.py)."""
    if txtp == WHT_WHT:
        for i in range(len(ys)):
            r0, c0 = ys[i], xs[i]
            _wht_add(dst[r0 : r0 + h, c0 : c0 + w], cfs[i], bpc)
        return
    res = compute_residual_batch(cfs, eobs, w, h, txtp, bpc)
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    rows = ys[:, None, None] + np.arange(h)[None, :, None]
    cols = xs[:, None, None] + np.arange(w)[None, None, :]
    pixel_max = (1 << bpc) - 1
    win = dst[rows, cols].astype(np.int64)
    dst[rows, cols] = np.clip(win + res, 0, pixel_max).astype(dst.dtype)


def compute_residual_batch(cfs, eobs, w, h, txtp, bpc):
    """Batched inverse transform WITHOUT the pixel add: (N, sw*sh) coef rows
    -> (N, h, w) int64 residuals. Shared by inv_txfm_add_batch and the
    wavefront residual precompute (intra blocks' residuals are
    neighbour-independent even though their predictions are not)."""
    first_name, second_name = _TXTP_1D[txtp]
    has_dconly = 1 if txtp == DCT_DCT else 0
    shift = _SHIFTS[(w, h)]
    is_rect2 = w * 2 == h or h * 2 == w
    rnd = (1 << shift) >> 1
    eobs = np.asarray(eobs)
    cfs = np.asarray(cfs, dtype=np.int64)
    N = len(eobs)

    dc_sel = eobs < has_dconly
    res = np.zeros((N, h, w), dtype=np.int64)

    if dc_sel.any():
        dc = cfs[:, 0]
        if is_rect2:
            dc = (dc * 181 + 128) >> 8
        dc = (dc * 181 + 128) >> 8
        dc = (dc + rnd) >> shift
        dc = (dc * 181 + 128 + 2048) >> 12
        res += np.where(dc_sel, dc, 0)[:, None, None]

    full = np.nonzero(~dc_sel)[0]
    if len(full):
        sh = min(h, 32)
        sw = min(w, 32)
        if bpc == 8:
            row_clip_min = col_clip_min = -(1 << 15)
        else:
            bitdepth_max = (1 << bpc) - 1
            row_clip_min = (~bitdepth_max) << 7
            col_clip_min = (~bitdepth_max) << 5
        row_clip_max = ~row_clip_min
        col_clip_max = ~col_clip_min
        M = len(full)
        cbuf = cfs[full, : sw * sh].reshape(M, sw, sh).transpose(0, 2, 1)
        if is_rect2:
            cbuf = (cbuf * 181 + 128) >> 8
        tmp = np.zeros((M, h, w), dtype=np.int64)
        tmp[:, :sh, :sw] = cbuf
        # first pass over rows: axis0 = w transform points, lanes = M*sh
        ct = np.ascontiguousarray(tmp[:, :sh, :].transpose(2, 0, 1).reshape(w, M * sh))
        _FAMILY[first_name][w](ct, row_clip_min, row_clip_max)
        tmp[:, :sh, :] = ct.reshape(w, M, sh).transpose(1, 2, 0)
        tmp[:, :sh, :] = np.clip(tmp[:, :sh, :] + rnd >> shift, col_clip_min, col_clip_max)
        # second pass over columns: axis0 = h points, lanes = M*w
        c2 = np.ascontiguousarray(tmp.transpose(1, 0, 2).reshape(h, M * w))
        _FAMILY[second_name][h](c2, col_clip_min, col_clip_max)
        res[full] = (c2.reshape(h, M, w).transpose(1, 0, 2) + 8) >> 4
    return res


def _wht_add(dst, coeff, bpc):
    # tmp[y][x] = coeff[y + x*4] >> 2; wht over rows then columns; add as-is.
    tmp = (np.asarray(coeff[:16], dtype=np.int64).reshape(4, 4).T) >> 2
    coeff[:16] = 0
    t = np.ascontiguousarray(tmp.T)  # axis0 = x (transform points per row)
    _wht4(t)
    tmp = np.ascontiguousarray(t.T)  # axis0 = y (per column)
    _wht4(tmp)
    pixel_max = (1 << bpc) - 1
    dst[:, :] = np.clip(dst.astype(np.int64) + tmp, 0, pixel_max).astype(dst.dtype)
