"""ctypes bindings for the native entropy core (csrc/host/entropy.c).

The shared libraries are built on demand with the system C compiler from
the reference's own copy of the C sources (csrc/host/) into its build/
directory, each named by its role and a hash of its sources
and flags (so an edited source rebuilds, and no name is shared with
another build of the same sources: a second dlopen of one path would share
its C statics).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD = os.path.join(_PKG, "build")


class MsacState(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_void_p),
        ("pos", ctypes.c_size_t),
        ("end", ctypes.c_size_t),
        ("dif", ctypes.c_uint64),
        ("rng", ctypes.c_uint32),
        ("cnt", ctypes.c_int32),
        ("allow_update", ctypes.c_int32),
    ]


class CoefCdfPtrs(ctypes.Structure):
    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "skip", "eob_bin_16", "eob_bin_32", "eob_bin_64", "eob_bin_128",
            "eob_bin_256", "eob_bin_512", "eob_bin_1024", "eob_hi_bit",
            "eob_base_tok", "base_tok", "br_tok", "dc_sign",
        )
    ]


class CoefCallParams(ctypes.Structure):
    _fields_ = [
        ("tdim_lw", ctypes.c_int32),
        ("tdim_lh", ctypes.c_int32),
        ("tdim_w", ctypes.c_int32),
        ("tdim_h", ctypes.c_int32),
        ("tdim_ctx", ctypes.c_int32),
        ("tdim_min", ctypes.c_int32),
        ("tdim_max", ctypes.c_int32),
        ("bdim_lw", ctypes.c_int32),
        ("bdim_lh", ctypes.c_int32),
        ("chroma", ctypes.c_int32),
        ("ss_ver", ctypes.c_int32),
        ("ss_hor", ctypes.c_int32),
        ("ctx_off_idx", ctypes.c_int32),
        ("txtp_mode", ctypes.c_int32),
        ("txtp_fixed", ctypes.c_int32),
        ("skip_txtp", ctypes.c_int32),
        ("idtx_val", ctypes.c_int32),
        ("txtp_cdf", ctypes.c_void_p),
        ("dq_dc", ctypes.c_int32),
        ("dq_ac", ctypes.c_int32),
        ("dq_shift", ctypes.c_int32),
        ("cf_max", ctypes.c_int32),
        ("a", ctypes.c_void_p),
        ("a_off", ctypes.c_int32),
        ("l", ctypes.c_void_p),
        ("l_off", ctypes.c_int32),
        ("skip_ctx_tbl", ctypes.c_void_p),
        ("lo_ctx_offsets", ctypes.c_void_p),
        ("tx_types_per_set", ctypes.c_void_p),
        ("tx_type_class", ctypes.c_void_p),
        ("scan", ctypes.c_void_p),
        ("qm", ctypes.c_void_p),
        ("cf", ctypes.c_void_p),
        ("eob", ctypes.c_int32),
        ("txtp", ctypes.c_int32),
        ("cf_ctx", ctypes.c_int32),
    ]


def build_host(name, srcs, flags) -> str | None:
    """Compile csrc/host/<srcs> into build/libavref_<name>-<hash>.so
    (written to a temporary name, then renamed: concurrent builders never
    load a partial file). Returns its path, or None if it cannot be built."""
    paths = [os.path.join(HOST_SRC, s) for s in srcs]
    if not all(os.path.exists(p) for p in paths):
        return None
    h = hashlib.sha1(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(BUILD, f"libavref_{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        os.makedirs(BUILD, exist_ok=True)
        subprocess.run(["cc", *flags, "-o", tmp, *paths], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    except (OSError, subprocess.CalledProcessError):
        return None
    return so


def _build() -> str | None:
    return build_host("entropy", ["entropy.c"],
                      ["-O3", "-shared", "-fPIC", "-fvisibility=hidden"])


class RefMvsCall(ctypes.Structure):
    _fields_ = [
        ("r", ctypes.c_void_p),
        ("r_stride", ctypes.c_int32),
        ("rp_proj", ctypes.c_void_p),
        ("rp_stride", ctypes.c_int32),
        ("bdims", ctypes.c_void_p),
        ("pocdiff", ctypes.c_int32 * 7),
        ("sign_bias", ctypes.c_int32 * 7),
        ("use_ref_frame_mvs", ctypes.c_int32),
        ("iw4", ctypes.c_int32),
        ("ih4", ctypes.c_int32),
        ("col_start", ctypes.c_int32),
        ("col_end", ctypes.c_int32),
        ("row_start", ctypes.c_int32),
        ("row_end", ctypes.c_int32),
        ("bs", ctypes.c_int32),
        ("bw4", ctypes.c_int32),
        ("bh4", ctypes.c_int32),
        ("bx4", ctypes.c_int32),
        ("by4", ctypes.c_int32),
        ("ref0", ctypes.c_int32),
        ("ref1", ctypes.c_int32),
        ("edge_has_tr", ctypes.c_int32),
        ("force_integer_mv", ctypes.c_int32),
        ("hp", ctypes.c_int32),
        ("use_rfm_hdr", ctypes.c_int32),
        ("gmv", (ctypes.c_int32 * 2) * 2),
        ("tgmv", (ctypes.c_int32 * 2) * 2),
        ("out_mv", ((ctypes.c_int16 * 2) * 2) * 8),
        ("out_weight", ctypes.c_int32 * 8),
        ("out_cnt", ctypes.c_int32),
        ("out_ctx", ctypes.c_int32),
    ]


def _load_refmvs():
    built = build_host("refmvs", ["refmvs.c"],
                       ["-O3", "-shared", "-fPIC", "-fvisibility=hidden"])
    if built is None:
        return None
    try:
        lib = ctypes.CDLL(built)
    except OSError:
        return None
    lib.dav1d_refmvs_find.argtypes = [ctypes.POINTER(RefMvsCall)]
    lib.dav1d_refmvs_find.restype = None
    return lib


def _load():
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    P = ctypes.POINTER
    lib.msac_init.argtypes = [
        P(MsacState), ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.msac_init.restype = None
    lib.msac_decode_bool_equi.argtypes = [P(MsacState)]
    lib.msac_decode_bool_equi.restype = ctypes.c_uint32
    lib.msac_decode_bool.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_bool.restype = ctypes.c_uint32
    lib.msac_decode_bool_adapt.argtypes = [P(MsacState), ctypes.c_void_p]
    lib.msac_decode_bool_adapt.restype = ctypes.c_uint32
    lib.msac_decode_symbol_adapt.argtypes = [
        P(MsacState), ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.msac_decode_symbol_adapt.restype = ctypes.c_uint32
    lib.msac_decode_hi_tok.argtypes = [P(MsacState), ctypes.c_void_p]
    lib.msac_decode_hi_tok.restype = ctypes.c_uint32
    lib.msac_decode_bools.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_bools.restype = ctypes.c_uint32
    lib.msac_decode_uniform.argtypes = [P(MsacState), ctypes.c_uint32]
    lib.msac_decode_uniform.restype = ctypes.c_uint32
    lib.msac_decode_subexp.argtypes = [
        P(MsacState), ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
    ]
    lib.msac_decode_subexp.restype = ctypes.c_int32
    lib.dav1d_decode_coefs.argtypes = [
        P(MsacState), P(CoefCdfPtrs), P(CoefCallParams),
    ]
    lib.dav1d_decode_coefs.restype = None
    return lib


LIB = _load()
AVAILABLE = LIB is not None


LIB_REFMVS = _load_refmvs()
