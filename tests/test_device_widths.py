"""Device-path conformance at non-QCIF widths (a regression class: an
earlier 720p corruption was a width-dependent bug QCIF could never
catch).  The packed DPB rows hold luma_lanes(W) = (W + 64) / 4 u32 words,
so each width below is a distinct row shape:

  176px  ->  60 words   (covered by test_device_pipeline at QCIF)
  512px  -> 144 words
  976px  -> 260 words

with P-frame MC + deblock + intra exercised against the libavcodec
golden.
"""

import numpy as np
import pytest

from tools import streams


def _decode(path: str) -> np.ndarray:
    from arrow_h264_tpu.api import Decoder
    dec = Decoder()
    frames = [np.frombuffer(f.planar(), np.uint8)
              for f in dec.decode_annexb(open(path, "rb").read())]
    return np.stack(frames)


@pytest.mark.parametrize("w,h", [(512, 80), (976, 64)])
def test_pallas_width_classes_p(h264ref, tmp_path, w, h):
    yuv = streams.make_content(w, h, 3, seed=w)
    path = str(tmp_path / f"w{w}.264")
    opts = ["profile=baseline", "qp=28", "g=250", "bf=0", "refs=1",
            "keyint_min=250",
            f"x264-params=cabac=0:subme=6:{streams.X264_COMMON}"]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode(path)
    assert ours.shape == golden.shape
    for f in range(ours.shape[0]):
        assert np.array_equal(ours[f], golden[f]), \
            f"{w}x{h} frame {f}: {int((ours[f] != golden[f]).sum())} diffs"


def test_pallas_width_256_high_cabac(h264ref, tmp_path):
    """512px geometry through the High/CABAC path (8x8 + B-frames)."""
    w, h = 512, 80
    yuv = streams.make_content(w, h, 4, seed=9)
    path = str(tmp_path / "w512high.264")
    opts = ["profile=high", "qp=28", "g=250", "bf=1", "refs=2",
            "keyint_min=250",
            "x264-params=cabac=1:8x8dct=1:weightb=1:b-pyramid=0:"
            + streams.X264_COMMON]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode(path)
    assert ours.shape == golden.shape
    for f in range(ours.shape[0]):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} diffs"
