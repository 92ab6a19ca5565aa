"""SE-level trace parity: the shipped C++ engine vs the Python oracle.

--trace-se (the JM TRACE analog, SURVEY.md §5) must work on BOTH entropy
engines and produce IDENTICAL traces on a conforming stream, so an
entropy bug in either engine can be localized to the first diverging
syntax element by diffing the two dumps.

The C++ records come from a -DH264E_TRACE build (cpp/entropy.cpp
H264E_TR hooks); positions are logical consumed bits, which for the
scaled-offset FastCab engine (pos - s) must agree with the Python
engine's lagging per-renorm reads — this test is what pins that.
"""

import io

import pytest

from arrow_h264_tpu.api import Decoder
from tools import streams

CONFIGS = {
    "p_cavlc": (176, 144, streams.CONFIG_OPTS[2]),
    "b_cabac": (176, 144, streams.CONFIG_OPTS[3]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trace_se_cpp_matches_python(h264ref, tmp_path, name):
    w, h, opts = CONFIGS[name]
    yuv = streams.make_content(w, h, 4, seed=hash(name) % 1000)
    path = str(tmp_path / f"{name}.264")
    streams.encode(yuv, w, h, path, opts)
    data = open(path, "rb").read()

    traces = {}
    for engine in ("cpp", "python"):
        sink = io.StringIO()
        dec = Decoder(entropy=engine, trace_se=sink)
        assert dec.entropy == engine
        for _ in dec.decode_annexb(data):
            pass
        traces[engine] = sink.getvalue()

    cpp_lines = traces["cpp"].splitlines()
    py_lines = traces["python"].splitlines()
    assert len(cpp_lines) > 1000, "trace suspiciously short"
    for i, (a, b) in enumerate(zip(cpp_lines, py_lines)):
        assert a == b, f"first trace divergence at record {i}: {a!r} != {b!r}"
    assert len(cpp_lines) == len(py_lines)
