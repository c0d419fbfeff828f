"""The port's own host front end against rav1d_tpu's.

rav1d_tpu_torch carries copies of the JAX package's JAX-free modules
(tables, syntax, entropy, headers, OBU parsing, io, the native syntax pass,
the numpy host path, the planner, pictures, the decoder) instead of
importing them. Checked here:

(a) no file of the port, and not chip_smoke.py, imports rav1d_tpu or jax
    (an AST scan), and a fresh process that imports every module of the
    port and decodes on the engine and on the host path loads neither;
(b) every copy is byte-identical to its original, except the seam files,
    which must differ;
(c) the sequence and frame headers both packages parse from the same bytes
    are equal, field by field (synthetic streams; small conformance
    vectors where the test data exists);
(d) the port's host path (Decoder(host_path=True)) decodes to the same MD5
    as rav1d_tpu's host path, on still pictures and on an inter stream;
(e) the 1080p digests chip_smoke.py holds the card to
    (rav1d_tpu_torch/smoke_digests.json: the still pictures and the inter
    sequence) are rav1d_tpu's host path's; so are its 2160p ones ("uhd",
    marked slow: -m slow).

Objects never cross between the packages: the comparisons are of bytes,
plain values and digests. Tolerance: exact.
"""

import ast
import dataclasses
import enum
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import rav1d_tpu
import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.headers import PixelLayout as PL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "rav1d_tpu_torch")

# (port file, original), both relative to the repo
COPIES = [
    (f"rav1d_tpu_torch/{p}", f"rav1d_tpu/{p}") for p in (
        "tables/__init__.py", "tables/block_tables.py", "tables/spec_data.py",
        "tables/qm.py", "tables/wedge.py", "tables/spec_tables.npz",
        "tables/default_cdf.npz",
        "syntax/__init__.py", "syntax/levels.py", "syntax/intra_edge.py",
        "syntax/env.py", "syntax/refmvs.py", "syntax/decode.py",
        "bits/__init__.py", "entropy/__init__.py", "entropy/cdf.py",
        "entropy/msac.py", "headers.py", "obu.py", "io/__init__.py",
        "io/ivf.py", "io/muxers.py", "native/__init__.py", "native/syntax.py",
        "ops/ref/__init__.py", "ops/ref/itx.py", "ops/ref/ipred.py",
        "ops/ref/lf.py", "ops/ref/lr.py", "ops/ref/cdef.py", "ops/ref/mc.py",
        "ops/ref/fg.py", "recon/__init__.py", "recon/store.py",
        "recon/coefs.py", "recon/ipred_prepare.py", "recon/intra.py",
        "recon/inter.py", "recon/warp.py", "recon/lf_mask.py", "recon/lf.py",
        "recon/cdef_apply.py", "recon/lr_apply.py", "recon/superres.py",
        "recon/fg_apply.py", "recon/frame.py", "engine/plan.py",
        "engine/inter.py", "picture.py", "decoder.py", "cli.py",
        "parallel/__init__.py",
    )
] + [(f"rav1d_tpu_torch/csrc/host/{c}", f"native/{c}")
     for c in ("entropy.c", "refmvs.c", "syntax.c")]

# the copies that differ from their originals, and why: the native loader
# builds the port's own C copies into rav1d_tpu_torch/build/; the decoder
# runs the dense pass on the torch engine with its own upload context and
# drops the JAX engine's frame ring; pictures have nothing to fetch;
# decode_frame_dense takes that context, and on the engine leaves a key
# frame's records unconverted; the planner's _fb reads no environment
# switch, and it plans such a frame in C (native/plan.py); engine/inter.py
# (collect_inter) imports no JAX and leaves out IdxBlob, _slice (unused by
# the v3 engine) and dev_plane (the port keeps reference planes on the
# device in engine/run.py); cli.py has
# a --device option for the decoder's engine and its own VERSION; the C
# syntax pass (csrc/host/syntax.c) keeps record_lf_inter's and
# read_pal_indices' scratch buffers on the stack, where the original's are
# static and race when a frame's tiles decode on parallel threads
# (tests/test_torch_headers.py)
SEAMS = {
    "rav1d_tpu_torch/native/__init__.py", "rav1d_tpu_torch/native/syntax.py",
    "rav1d_tpu_torch/decoder.py", "rav1d_tpu_torch/picture.py",
    "rav1d_tpu_torch/recon/frame.py", "rav1d_tpu_torch/engine/plan.py",
    "rav1d_tpu_torch/engine/inter.py", "rav1d_tpu_torch/cli.py",
    "rav1d_tpu_torch/csrc/host/syntax.c",
}


def ref_md5s(packets, **settings):
    return synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False, **settings)),
        packets, eagain=rav1d_tpu.EAgain)


def host_md5s(packets):
    return synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), packets)


# ------------------------------ (a) imports ------------------------------


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_file_imports_rav1d_tpu_or_jax():
    bad = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), node.lineno, n)
                    for n in names if n.split(".")[0] in ("rav1d_tpu", "jax")]
    assert len(_sources()) > 40
    assert not bad, bad


def test_fresh_process_loads_neither():
    code = (
        "import pkgutil, sys\n"
        "import rav1d_tpu_torch as T\n"
        "for m in pkgutil.walk_packages(T.__path__, 'rav1d_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from rav1d_tpu_torch import synth\n"
        "pk = [synth.still_picture(72, 40, 3)]\n"
        "a = synth.decode_md5s(T.Decoder(device='cpu'), pk)\n"
        "b = synth.decode_md5s(T.Decoder(host_path=True), pk)\n"
        "assert a == b and len(a) == 1, (a, b)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'rav1d_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_no_module_reads_the_environment():
    """The two packages share a process in the tests; a switch of the JAX
    package's (RAV1D_TPU_NO_NATIVE, RAV1D_ENGINE_SKIP, ...) must not move
    the port."""
    bad = []
    for path in (p for p in _sources() if p.startswith(PORT + os.sep)):
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        bad += [(os.path.relpath(path, REPO), node.lineno)
                for node in ast.walk(tree)
                if isinstance(node, ast.Attribute)
                and node.attr in ("environ", "getenv")]
    assert not bad, bad


def test_native_syntax_loads_under_the_reference_switches():
    code = ("from rav1d_tpu_torch.native import LIB, LIB_REFMVS, syntax\n"
            "assert LIB and LIB_REFMVS and syntax.enabled()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, RAV1D_TPU_NO_NATIVE="1",
               RAV1D_TPU_NO_NATIVE_SYNTAX="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


# ------------------------------ (b) copies -------------------------------


@pytest.mark.parametrize("port,orig", COPIES, ids=[c[0][16:] for c in COPIES])
def test_copy_is_identical_outside_the_seams(port, orig):
    with open(os.path.join(REPO, port), "rb") as a, \
            open(os.path.join(REPO, orig), "rb") as b:
        same = a.read() == b.read()
    assert same != (port in SEAMS)


def test_seams_are_copies():
    assert SEAMS <= {p for p, _ in COPIES}


# ------------------------------ (c) headers ------------------------------


def _plain(x):
    """A header object as plain values (enums by class name and value),
    comparable across the two packages' classes."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, int(x.value))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    assert x is None or isinstance(x, (int, float, str, bytes)), type(x)
    return x


def _headers(dec, packets, eagain):
    out = []
    for data in packets:
        dec.send_data(data)
        while True:
            try:
                pic = dec.get_picture()
            except eagain:
                break
            out.append((_plain(pic.seq_hdr), _plain(pic.frame_hdr)))
    return out


def _compare_headers(packets):
    ref = _headers(rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False)),
                   packets, rav1d_tpu.EAgain)
    got = _headers(T.Decoder(T.Settings(apply_grain=False), host_path=True),
                   packets, T.EAgain)
    assert ref
    assert got == ref
    from rav1d_tpu.obu import parse_sequence_header as ref_seq

    from rav1d_tpu_torch.obu import parse_sequence_header as seq

    assert _plain(seq(packets[0])) == _plain(ref_seq(packets[0]))


STREAMS = {
    "still": lambda: [synth.still_picture(96, 64, 1)],
    "still-10bit": lambda: [synth.still_picture(96, 64, 2, bpc=10)],
    "still-superres": lambda: [synth.still_picture(96, 64, 1, superres=True)],
    "key-then-inter": lambda: synth.key_then_inter(96, 64, 1),
    "inter-sequence": lambda: synth.inter_sequence(96, 64, 1),
    "inter-sequence-intrabc": lambda: synth.inter_sequence(96, 64, 1,
                                                           intrabc=True),
    "still-8bit-444": lambda: [synth.still_picture(96, 64, 3,
                                                   layout=PL.I444)],
    "still-10bit-422": lambda: [synth.still_picture(96, 64, 4, bpc=10,
                                                    layout=PL.I422)],
    "still-12bit-400": lambda: [synth.still_picture(96, 64, 5, bpc=12,
                                                    layout=PL.I400)],
    "still-12bit-420": lambda: [synth.still_picture(96, 64, 6, bpc=12)],
    "inter-sequence-10bit-422": lambda: synth.inter_sequence(
        96, 64, 1, bpc=10, layout=PL.I422),
    "inter-sequence-12bit-444": lambda: synth.inter_sequence(
        96, 64, 2, bpc=12, layout=PL.I444),
    "inter-sequence-10bit-400": lambda: synth.inter_sequence(
        96, 64, 3, bpc=10, layout=PL.I400),
    "inter-sequence-superres": lambda: synth.inter_sequence(
        96, 64, 1, superres=True),
    "inter-sequence-header-tools": lambda: synth.inter_sequence(
        96, 64, 1, tools=synth.Tools(
            sb128=True, segmentation=True, delta_q=True, delta_lf_multi=True,
            lf_deltas=True, tx_mode_largest=True)),
    "still-tiles-lr64": lambda: [synth.still_picture(
        320, 192, 2, tools=synth.Tools(tiles=(1, 1), lr_unit_shift=0,
                                       segmentation=True, delta_q=True))],
}


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_headers_match_on_synthetic_streams(kind):
    _compare_headers(STREAMS[kind]())


VECTORS = ["8-bit/size/av1-1-b8-01-size-16x16.ivf",
           "8-bit/size/av1-1-b8-01-size-32x16.ivf"]


@pytest.mark.parametrize("rel", VECTORS, ids=["16x16", "32x16"])
def test_headers_match_on_vectors(rel):
    from conftest import TEST_DATA

    path = os.path.join(TEST_DATA, rel)
    if not os.path.exists(path):
        pytest.skip("dav1d-test-data not present")
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    _compare_headers([pkt.data for pkt in IvfDemuxer(path)])


# ------------------------------ (d) host path ----------------------------


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("w,h", [(72, 40), (136, 96), (200, 120)])
def test_host_path_matches_on_still_pictures(w, h, seed):
    packets = [synth.still_picture(w, h, seed)]
    assert host_md5s(packets) == ref_md5s(packets)


@pytest.mark.parametrize("seed", [1, 3])
def test_host_path_matches_on_inter(seed):
    """Key frame then an inter frame: the copied inter recon."""
    packets = synth.key_then_inter(96, 64, seed)
    want = ref_md5s(packets)
    assert len(want) == 2
    assert host_md5s(packets) == want


def test_engine_on_cpu_matches_host_paths():
    packets = [synth.still_picture(136, 96, 10)]
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == host_md5s(packets) == ref_md5s(packets)
    assert T.engine.stats["frames"] - before["frames"] == 1
    assert T.engine.stats["fallback"] == before["fallback"]


def test_device_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        assert T.Decoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.Decoder()
    assert T.Decoder(host_path=True).uploader is None


# ------------------------------ (e) digests ------------------------------


with open(os.path.join(PORT, "smoke_digests.json")) as _fh:
    DIGESTS = json.load(_fh)


# the 3840x2160 streams: 30-90 s each on rav1d_tpu's host path
UHD_CASES = [pytest.param("uhd:" + name, marks=pytest.mark.slow)
             for name in sorted(DIGESTS["uhd"]["streams"])]


@pytest.mark.parametrize("seed", sorted(DIGESTS["md5"]) + ["inter"]
                         + sorted(DIGESTS["formats"]) + UHD_CASES)
def test_smoke_digests_are_the_reference_host_paths(seed):
    if seed.startswith("uhd:"):  # synth.uhd_stream, tiles on one thread
        name = seed[len("uhd:"):]
        packets = synth.uhd_stream(DIGESTS, name)
        assert ref_md5s(packets, n_threads=1) == \
            DIGESTS["uhd"]["streams"][name]["md5"]
        return
    if seed == "inter":  # synth.inter_sequence: one MD5 per frame
        inter = DIGESTS["inter"]
        packets = synth.inter_sequence(DIGESTS["width"], DIGESTS["height"],
                                       inter["seed"])
        assert ref_md5s(packets) == inter["md5"]
        return
    if seed in DIGESTS["formats"]:  # synth.smoke_stream's other formats
        packets = synth.smoke_stream(DIGESTS, seed)
        assert ref_md5s(packets) == DIGESTS["formats"][seed]["md5"]
        return
    data = synth.still_picture(DIGESTS["width"], DIGESTS["height"], int(seed))
    assert ref_md5s([data]) == [DIGESTS["md5"][seed]]
