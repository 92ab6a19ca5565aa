"""Device (JAX) pipeline conformance: bit-exact vs libavcodec golden (config 1)."""

import numpy as np
import pytest

from arrow_h264_tpu.api import Decoder
from tools import streams


def _decode_device(path: str) -> np.ndarray:
    dec = Decoder()
    frames = []
    for f in dec.decode_annexb(open(path, "rb").read()):
        frames.append(np.frombuffer(f.planar(), np.uint8))
    return np.stack(frames)


@pytest.mark.parametrize("qp", [18, 30, 44])
def test_device_config1(h264ref, tmp_path, qp):
    w, h = 176, 144
    yuv = streams.make_content(w, h, 2, seed=qp + 1)
    path = str(tmp_path / f"d1_qp{qp}.264")
    opts = ["profile=baseline", f"qp={qp}", "g=1", "bf=0", "refs=1",
            f"x264-params=cabac=0:{streams.X264_COMMON}"]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert ours.shape == golden.shape
    if not np.array_equal(ours, golden):
        ysz = gw * gh
        for f in range(ours.shape[0]):
            dy = int((ours[f, :ysz] != golden[f, :ysz]).sum())
            dc = int((ours[f, ysz:] != golden[f, ysz:]).sum())
            if dy or dc:
                yo = ours[f, :ysz].reshape(gh, gw).astype(int)
                yg = golden[f, :ysz].reshape(gh, gw).astype(int)
                pos = np.argwhere(yo != yg)
                msg = f"frame {f}: {dy} luma / {dc} chroma diffs"
                if len(pos):
                    py, px = pos[0]
                    msg += f"; first at ({px},{py}): {yo[py,px]} vs {yg[py,px]}"
                raise AssertionError(msg)


def test_device_config2_p_frames(h264ref, tmp_path):
    """Config 2 on the device pipeline: P-frames, quarter-pel MC, DPB slots."""
    w, h = 176, 144
    yuv = streams.make_content(w, h, 5, seed=42)
    path = str(tmp_path / "d2.264")
    streams.encode(yuv, w, h, path, streams.CONFIG_OPTS[2])
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert ours.shape == golden.shape
    for f in range(ours.shape[0]):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"


def test_device_config2_multiref(h264ref, tmp_path):
    w, h = 176, 144
    yuv = streams.make_content(w, h, 6, seed=7)
    path = str(tmp_path / "d2mr.264")
    opts = ["profile=baseline", "qp=24", "g=250", "bf=0", "refs=3",
            "keyint_min=25",
            f"x264-params=cabac=0:subme=7:{streams.X264_COMMON}"]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert np.array_equal(ours, golden)


def test_device_config3_cabac_bframes(h264ref, tmp_path):
    """Config 3 device path: CABAC + B-frames + bi-pred + implicit weights."""
    w, h = 176, 144
    yuv = streams.make_content(w, h, 6, seed=23)
    path = str(tmp_path / "d3.264")
    opts = ["profile=main", "qp=26", "g=250", "bf=2", "refs=3", "keyint_min=25",
            "x264-params=cabac=1:weightb=1:b-pyramid=0:direct=spatial:"
            f"subme=7:{streams.X264_COMMON}"]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert np.array_equal(ours, golden), \
        f"{int((ours != golden).sum())} byte diffs"


def test_device_config4_high(h264ref, tmp_path):
    """Config 4 device path: 8x8 transform, weighted P, custom scaling."""
    w, h = 176, 144
    yuv = streams.make_content(w, h, 6, seed=29)
    path = str(tmp_path / "d4.264")
    opts = ["profile=high", "qp=26", "g=250", "bf=2", "refs=3", "keyint_min=25",
            "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:b-pyramid=0:"
            f"cqm=jvt:{streams.X264_COMMON}"]
    streams.encode(yuv, w, h, path, opts)
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert np.array_equal(ours, golden), \
        f"{int((ours != golden).sum())} byte diffs"


def test_device_lossless_bypass(h264ref, tmp_path):
    """FRExt lossless (qpprime_y_zero_transform_bypass_flag): QP'==0 MBs
    skip scaling+transform (spec 8.5.15) and vertical/horizontal intra
    blocks reconstruct via sample-wise DPCM (8.3.5, implemented as a
    residual cumsum — ops.transforms._tile_cumsum).  x264 at qp=0 also
    emits CABAC I_PCM MBs, pinning the terminate->PCM byte-align
    transition.  Lossless means the output must equal the encoder INPUT
    as well as the libavcodec golden."""
    from tools import streams as st
    w, h = 176, 144
    yuv = st.make_content(w, h, 5, seed=23)
    path = str(tmp_path / "lossless.264")
    st.encode(yuv, w, h, path, st.CONFIG_OPTS["lossless"])
    golden, gw, gh = st.golden_decode(path)
    ours = _decode_device(path)
    assert ours.shape == golden.shape
    for f in range(ours.shape[0]):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"
    # decode order == input order here (B frames reorder POC, but output
    # order is display order); lossless => byte-equal to the source
    src = np.asarray(yuv).reshape(ours.shape[0], -1)
    assert np.array_equal(ours, src)


def test_device_lossless_cavlc_dpcm(h264ref, tmp_path):
    """Lossless CAVLC variant (no I_PCM path, exercises i4/i8 DPCM)."""
    from tools import streams as st
    w, h = 164, 132           # non-MB-multiple: cropping under bypass
    yuv = st.make_content(w, h, 3, seed=29)
    path = str(tmp_path / "lossless_cavlc.264")
    st.encode(yuv, w, h, path,
              ["profile=high444", "qp=0", "g=250", "bf=0", "refs=2",
               f"x264-params=cabac=0:8x8dct=1:{st.X264_COMMON}"])
    golden, gw, gh = st.golden_decode(path)
    ours = _decode_device(path)
    assert ours.shape == golden.shape
    assert np.array_equal(ours, golden)


@pytest.mark.parametrize("cfg", [2, 3, 4])
def test_device_cif(h264ref, tmp_path, cfg):
    """Configs 2-4 at CIF (352x288) on the device pipeline: wider
    geometry (mb_w=22) than the QCIF tests — band layouts, knight-phase
    schedules, and packed row widths all differ with mb_w."""
    w, h = 352, 288
    yuv = streams.make_content(w, h, 4, seed=60 + cfg)
    path = str(tmp_path / f"dcif{cfg}.264")
    streams.encode(yuv, w, h, path, streams.CONFIG_OPTS[cfg])
    golden, gw, gh = streams.golden_decode(path)
    ours = _decode_device(path)
    assert ours.shape == golden.shape
    for f in range(ours.shape[0]):
        assert np.array_equal(ours[f], golden[f]), \
            f"frame {f}: {int((ours[f] != golden[f]).sum())} byte diffs"
