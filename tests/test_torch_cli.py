"""rav1d_tpu_torch.cli, the dav1d-compatible command line, against
rav1d_tpu.cli.

Synthetic streams (an 8-bit 4:2:0 key frame and two inter frames, a 10-bit
4:2:2 still picture) are written to IVF files with synth.write_ivf. Both
CLIs run in process through main([...]): rav1d_tpu.cli on its host path,
rav1d_tpu_torch.cli with --device cpu, so its engine runs every program
with the kernels' plain versions. Checked: --verify returns 0 on the MD5
of the port's host path and 1 on another MD5; the y4m, yuv and md5 outputs,
with and without --limit and --skip, are byte-equal between the two CLIs;
--frametimes writes one line per output frame; --version prints the
port's VERSION. Tolerance: exact.
"""

import pytest

from rav1d_tpu import cli as ref_cli
from rav1d_tpu_torch import cli, synth
from rav1d_tpu_torch.headers import PixelLayout as PL

STREAMS = {
    "8bit-inter": (lambda: synth.inter_sequence(136, 96, 2), 136, 96),
    "10bit-422-still": (lambda: [synth.still_picture(
        120, 72, 5, bpc=10, layout=PL.I422)], 120, 72),
}


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream(request, tmp_path_factory):
    """(IVF path, packets) of a synthetic stream."""
    make, w, h = STREAMS[request.param]
    packets = make()
    path = str(tmp_path_factory.mktemp("cli") / f"{request.param}.ivf")
    synth.write_ivf(path, packets, w, h)
    return path, packets


def test_verify_returns_0_on_the_host_path_md5_and_1_on_another(stream,
                                                                tmp_path):
    path, packets = stream
    md5 = synth.stream_md5(packets)
    times = tmp_path / "frametimes.txt"
    assert cli.main(["-i", path, "--verify", md5, "--device", "cpu", "-q",
                     "--frametimes", str(times)]) == 0
    lines = times.read_text().splitlines()
    assert len(lines) == len(packets) and all(int(v) > 0 for v in lines)
    wrong = "0" * 32
    assert cli.main(["-i", path, "--verify", wrong, "--device", "cpu",
                     "-q"]) == 1
    assert ref_cli.main(["-i", path, "--verify", md5, "-q"]) == 0
    assert ref_cli.main(["-i", path, "--verify", wrong, "-q"]) == 1


# (output file name, extra options)
OUTPUTS = [
    ("out.y4m", []),
    ("out.yuv", []),
    ("out.md5", []),
    ("out.y4m", ["--limit", "2"]),
    ("out.yuv", ["--skip", "1"]),
    ("out.md5", ["--skip", "1", "--limit", "1"]),
]


@pytest.mark.parametrize("name,opts", OUTPUTS,
                         ids=["-".join([n] + o) for n, o in OUTPUTS])
def test_outputs_equal_the_reference_cli(stream, name, opts, tmp_path):
    path, packets = stream
    got, want = tmp_path / ("port-" + name), tmp_path / ("ref-" + name)
    assert cli.main(["-i", path, "-o", str(got), "--device", "cpu", "-q"]
                    + opts) == 0
    assert ref_cli.main(["-i", path, "-o", str(want), "-q"] + opts) == 0
    assert got.read_bytes() == want.read_bytes()
    skip = int(opts[opts.index("--skip") + 1]) if "--skip" in opts else 0
    if len(packets) > skip or name.endswith(".md5"):  # frames written
        assert got.stat().st_size > 0


def test_version_prints_the_ports_version(capsys):
    assert cli.main(["--version"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == cli.VERSION
    assert "rav1d_tpu_torch" in cli.VERSION != ref_cli.VERSION
