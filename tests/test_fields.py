"""PAFF field-decoding conformance (SURVEY.md §2 picture/slice driver
field handling; spec 7.4.3 / 8.2.1 / 8.2.4.2.5 / Tables 8-13, 8-14).

Streams are hand-authored (x264 cannot emit PAFF — tools/field_streams),
but unlike FMO the golden oracle is the system libavcodec, which decodes
field pictures natively: every test here byte-compares against an
independent decoder.
"""

import numpy as np
import pytest

from arrow_h264_tpu.api import Decoder

from tools import field_streams as FS
from tools.streams import golden_decode


def _decode_ours(data: bytes, entropy: str) -> list[np.ndarray]:
    dec = Decoder(entropy=entropy)
    return [np.concatenate([f.y.ravel(), f.cb.ravel(), f.cr.ravel()])
            for f in dec.decode_annexb(data)]


def _golden(data: bytes, tmp_path) -> list[np.ndarray]:
    p = tmp_path / "s.264"
    p.write_bytes(data)
    frames, _w, _h = golden_decode(str(p))
    return list(frames)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_field_pcm(tmp_path, entropy):
    """I_PCM field pairs: framing, field POC, pairing, woven output."""
    data = FS.make_field_pcm_stream()
    ours = _decode_ours(data, entropy)
    construct = FS.field_pcm_golden()
    assert len(ours) == len(construct)
    for o, g in zip(ours, construct):
        assert np.array_equal(o, g)
    golden = _golden(data, tmp_path)
    assert len(golden) == len(ours)
    for o, g in zip(ours, golden):
        assert np.array_equal(o, g)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_field_cavlc_scan(tmp_path, entropy):
    """I16 DC+AC CAVLC residuals through the FIELD inverse scan: a wrong
    Table 8-13 field column breaks byte-equality against libavcodec."""
    data = FS.make_field_cavlc_stream()
    ours = _decode_ours(data, entropy)
    golden = _golden(data, tmp_path)
    assert len(ours) == len(golden) == 2   # 4 fields -> 2 woven frames
    for o, g in zip(ours, golden):
        assert np.array_equal(o, g)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_field_p_motion(tmp_path, entropy):
    """P fields referencing same- and opposite-parity fields (ref_idx 0/1
    through the 8.2.4.2.5 alternating list): pins field PicNums, the MC
    path on field planes, and the cross-parity chroma MV adjustment."""
    data = FS.make_field_p_stream()
    ours = _decode_ours(data, entropy)
    golden = _golden(data, tmp_path)
    assert len(ours) == len(golden)
    for i, (o, g) in enumerate(zip(ours, golden)):
        assert np.array_equal(o, g), f"frame {i} differs"


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_field_b_motion(tmp_path, entropy):
    """B fields with explicit L0/L1/Bi refs through the parity-
    alternating field B lists (8.2.4.2.4/8.2.4.2.5): pins field B list
    order, field PicNums in both lists, bipred averaging on field
    planes, and POC-ordered emission around a non-reference pair."""
    data = FS.make_field_b_stream()
    ours = _decode_ours(data, entropy)
    golden = _golden(data, tmp_path)
    assert len(ours) == len(golden) == 3
    for i, (o, g) in enumerate(zip(ours, golden)):
        assert np.array_equal(o, g), f"frame {i} differs"


def test_field_poc_and_units():
    """Field POC (type 0) and DPB unit bookkeeping on the PCM stream."""
    dec = Decoder(entropy="python")
    frames = list(dec.decode_annexb(FS.make_field_pcm_stream(n_frames=3)))
    assert [f.poc for f in frames] == [0, 2, 4]
    assert all(f.height == 4 * 32 for f in frames)


@pytest.mark.parametrize("entropy", ["python", "cpp"])
def test_field_frame_num_gap(entropy):
    """frame_num gap in a field-coded stream (8.2.5.2): the synthesized
    non-existing frame enters the field lists as a complementary field
    pair, shifting the real fields' list indices — each P field's coded
    ref_idx 2 only lands on its same-parity I field if the gap pair was
    inserted.  Golden is constructed (libavcodec does not synthesize
    gap refs in field mode)."""
    data = FS.make_field_gap_stream()
    ours = _decode_ours(data, entropy)
    golden = FS.field_gap_golden()
    assert len(ours) == len(golden) == 2   # I pair + P pair, woven
    for i, (o, g) in enumerate(zip(ours, golden)):
        assert np.array_equal(o, g), f"frame {i}"
