"""The reference is the port's host path, frozen: equal digests; and the
import rules: nothing the benchmark runs imports JAX or the JAX package
(top-level names compared whole), and the reference reaches nothing of
the port."""

import ast
import os
import subprocess
import sys
import types

import pytest

from avbench import reference, streamgen
from avbench.spec import HERE, ROOT
from avbench.window import digest


def _digests(dec, eagain, units):
    out = []
    for data in units:
        dec.send_data(data)
        while True:
            try:
                out.append(digest(dec.get_picture()))
            except eagain:
                break
    return out


@pytest.mark.parametrize("units", [
    streamgen.inter_sequence(640, 360, 31),
    [streamgen.still_picture(640, 360, 32)],
    [streamgen.still_picture(320, 180, 33, bpc=10)],
    streamgen.inter_sequence(352, 288, 34, tools=streamgen.Tools(film_grain=True)),
], ids=["group", "still", "still10", "grain_group"])
def test_reference_equals_port_host_path(units):
    from rav1d_tpu_torch.decoder import Decoder, EAgain

    want = _digests(Decoder(host_path=True), EAgain, units)
    got = _digests(reference.Decoder(), reference.EAgain, units)
    assert got == want and len(got) == len(units)


def _imports(path):
    """Top-level names of the modules a file imports (absolute imports)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        if os.sep + "tests" in d[len(HERE):] or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_imports_in_the_benchmark():
    bad = {(p, m) for p in _sources(HERE) for m in _imports(p)
           if m in ("jax", "jaxlib", "flax", "rav1d_tpu")}
    assert not bad


def test_reference_reaches_nothing_of_the_port():
    top = os.path.join(HERE, "reference")
    bad = {(p, m) for p in _sources(top) for m in _imports(p)
           if m in ("rav1d_tpu_torch", "rav1d_tpu", "torch", "avbench")}
    assert not bad
    code = ("import sys; import avbench.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(eval(out))  # noqa: S307 (a list literal this test printed)
    assert not loaded & {"rav1d_tpu_torch", "rav1d_tpu", "torch", "jax"}


def test_the_whole_names_rule(monkeypatch):
    """rav1d_tpu_torch and jax_like are not rav1d_tpu and jax."""
    from avbench.run import forbidden_modules

    for name in ("rav1d_tpu_torch.fake", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(forbidden_modules()) & {"rav1d_tpu", "jax", "flax"}
    for name in ("rav1d_tpu.fake", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"rav1d_tpu", "jax"} <= set(forbidden_modules())
