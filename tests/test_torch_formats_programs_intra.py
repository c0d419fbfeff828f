"""The port's programs against the JAX engine's on the two intra
combinations of tests/test_torch_formats_programs.py (which holds the
harness and says what is compared): a 12-bit 4:0:0 picture and an 8-bit
4:2:0 superres key frame. Tolerance: exact.
"""

import pytest

from test_torch_formats_programs import frame_of


@pytest.fixture(scope="module", params=["12bit-400-intra",
                                        "8bit-420-superres"])
def frame(request):
    return frame_of(request.param)


def test_blob_matches_run2(frame):
    frame.check_blob()


def test_resid(frame):
    frame.check_resid()


def test_inter(frame):
    frame.check_inter()


def test_wave(frame):
    frame.check_wave()


def test_filter(frame):
    frame.check_filter()
