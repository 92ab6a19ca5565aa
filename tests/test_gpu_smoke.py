"""Conformance configs 1-4 on the card: the committed smoke streams
through api.Decoder, every frame equal to its libavcodec golden hash.
Skips unless JAX runs on a GPU (JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/)."""

import pytest

from tools.make_smoke_streams import frame_hash, load


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["c1_qcif", "c2_cif", "c3_720p",
                                  "c4_1080p"])
def test_config_bit_exact_on_gpu(gpu, name):
    from arrow_h264_tpu.api import Decoder
    data, hashes = load(name)
    frames = list(Decoder().decode_annexb(data))
    assert [frame_hash(f.planar()) for f in frames] == hashes
