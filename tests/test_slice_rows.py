"""Slice -> device parameter-row assignment (ops.abi.assign_slice_rows).

The device ships per-slice parameters (weight tables, slogwd, deblock
offsets) as MAX_SLICES fixed rows.  Slice-per-MB-row encoders emit far
more than 15 slices per picture at HD; legal streams must not be
rejected — slices with identical device-visible parameters share a row
(the old hard reject failed such streams)."""

from types import SimpleNamespace

import numpy as np
import pytest

from arrow_h264_tpu.ops.abi import (
    CONCEAL_SLICE, MAX_SLICES, assign_slice_rows, empty_frame_abi,
    fill_weight_tables,
)


def _pps(**kw):
    d = dict(weighted_pred_flag=0, weighted_bipred_idc=0)
    d.update(kw)
    return SimpleNamespace(**d)


def _hdr(idc=0, a=0, b=0, is_p=False, is_b=False, **kw):
    d = dict(disable_deblocking_filter_idc=idc,
             slice_alpha_c0_offset_div2=a, slice_beta_offset_div2=b,
             is_p=is_p, is_b=is_b, pred_weights_l0=None,
             pred_weights_l1=None, luma_log2_weight_denom=0,
             chroma_log2_weight_denom=0)
    d.update(kw)
    return SimpleNamespace(**d)


def test_identity_when_rows_suffice():
    hdrs = [_hdr(a=i % 3) for i in range(MAX_SLICES - 1)]
    rl = [((), ())] * len(hdrs)
    assert assign_slice_rows(_pps(), hdrs, rl) == list(range(len(hdrs)))


def test_many_identical_slices_share_one_row():
    hdrs = [_hdr() for _ in range(68)]        # slice-per-MB-row 1080p
    rl = [((), ())] * 68
    rows = assign_slice_rows(_pps(), hdrs, rl)
    assert rows == [0] * 68
    assert max(rows) < CONCEAL_SLICE


def test_mixed_params_dedup():
    hdrs = [_hdr(a=i % 4, b=i % 2) for i in range(40)]
    rl = [((), ())] * 40
    rows = assign_slice_rows(_pps(), hdrs, rl)
    assert len(set(rows)) == len({(h.slice_alpha_c0_offset_div2,
                                   h.slice_beta_offset_div2)
                                  for h in hdrs})
    # equal params -> equal row, distinct params -> distinct row
    for i in range(40):
        for j in range(40):
            same = (hdrs[i].slice_alpha_c0_offset_div2,
                    hdrs[i].slice_beta_offset_div2) == \
                   (hdrs[j].slice_alpha_c0_offset_div2,
                    hdrs[j].slice_beta_offset_div2)
            assert (rows[i] == rows[j]) == same


def test_idc2_kept_unique_while_rows_remain():
    # 5 idc==2 slices among 20 identical idc==0: the boundary test for
    # idc==2 needs exact slice identity, so they stay unique
    hdrs = [_hdr(idc=2 if i < 5 else 0) for i in range(20)]
    rl = [((), ())] * 20
    rows = assign_slice_rows(_pps(), hdrs, rl)
    idc2 = [rows[i] for i in range(5)]
    assert len(set(idc2)) == 5
    assert len({rows[i] for i in range(5, 20)}) == 1
    assert not set(idc2) & {rows[i] for i in range(5, 20)}


def test_idc2_merges_only_on_overflow():
    # 30 identical idc==2 slices cannot all stay unique: they merge
    # (bounded deblock-only deviation) instead of failing the picture
    hdrs = [_hdr(idc=2) for _ in range(30)]
    rl = [((), ())] * 30
    rows = assign_slice_rows(_pps(), hdrs, rl)
    assert rows == [0] * 30


def test_truly_distinct_overflow_goes_dense():
    hdrs = [_hdr(a=i % 6, b=(i // 6) % 6, idc=i % 2) for i in range(24)]
    rl = [((), ())] * 24
    assert len({(h.disable_deblocking_filter_idc,
                 h.slice_alpha_c0_offset_div2,
                 h.slice_beta_offset_div2) for h in hdrs}) > MAX_SLICES - 1
    # overflow no longer rejects: assign returns None and
    # fill_weight_tables falls back to dense per-cell weights
    assert assign_slice_rows(_pps(), hdrs, rl) is None
    mb_w, mb_h = 1, 24
    abi = empty_frame_abi(mb_w, mb_h)
    abi["slice_id"] = np.arange(24, dtype=np.int32)
    fill_weight_tables(abi, _pps(), hdrs, rl, cur_poc=0)
    assert "wp" in abi and "logwd" in abi
    assert abi["wp"].shape == (24, 4, 4, 2, 3, 2)
    # unweighted slices -> identity weights everywhere
    assert (abi["wp"][..., 0] == 1).all() and (abi["wp"][..., 1] == 0).all()
    assert (abi["logwd"] == 0).all()
    # slice ids stay TRUE ids (deblock equality only)
    assert (np.asarray(abi["slice_id"]) == np.arange(24)).all()


def test_distinct_weight_tables_dense_values():
    # 18 P slices with distinct explicit l0 weights: the dense fallback
    # must reproduce each slice's (w, o) at its cells
    from arrow_h264_tpu.bitstream.slicehdr import PredWeight
    nsl = 18
    hdrs = []
    for s in range(nsl):
        hdrs.append(_hdr(
            is_p=True, luma_log2_weight_denom=5, chroma_log2_weight_denom=5,
            pred_weights_l0=[PredWeight(24 + s, s - 3, (30, 34), (2, -2))]))
    rl = [((), ())] * nsl
    pps = _pps(weighted_pred_flag=1)
    assert assign_slice_rows(pps, hdrs, rl) is None
    mb_w, mb_h = 2, nsl
    abi = empty_frame_abi(mb_w, mb_h)
    abi["slice_id"] = np.repeat(np.arange(nsl, dtype=np.int32), mb_w)
    abi["refidx"][..., 0] = 0          # every cell uses l0 ref 0
    fill_weight_tables(abi, pps, hdrs, rl, cur_poc=0)
    wp = abi["wp"].reshape(mb_h, mb_w, 4, 4, 2, 3, 2)
    for s in range(nsl):
        assert (wp[s, ..., 0, 0, 0] == 24 + s).all()    # luma w0
        assert (wp[s, ..., 0, 0, 1] == s - 3).all()     # luma o0
        assert (wp[s, ..., 0, 1, 0] == 30).all()        # cb w0
    assert (abi["logwd"] == 5).all()


def test_many_distinct_weight_slices_conformance(h264ref, tmp_path):
    """End-to-end: 18 slices/picture with DISTINCT pred-weight tables
    (> 15 rows -> dense per-cell weight fallback) decodes bit-exact vs
    the libavcodec golden, on the shipped Decoder and on the
    BatchDecoder (where the round ships dense weights for every lane)."""
    from tools.streams import golden_decode
    from tools.wp_streams import make_many_weight_slices_stream
    from arrow_h264_tpu.api import Decoder
    from arrow_h264_tpu.parallel.batch import BatchDecoder

    data = make_many_weight_slices_stream(mb_w=4, mb_h=18, n_p=2)
    p = tmp_path / "wp18.264"
    p.write_bytes(data)
    golden, w, h = golden_decode(str(p))
    assert golden.shape[0] == 3

    frames = list(Decoder(entropy="cpp").decode_annexb(data))
    assert len(frames) == 3
    for i, f in enumerate(frames):
        ours = np.concatenate([f.y.ravel(), f.cb.ravel(), f.cr.ravel()])
        assert np.array_equal(ours, golden[i]), f"frame {i} (Decoder)"

    bd = BatchDecoder(n_streams=2)
    rows = bd.decode([data, data])
    assert bd.errors == [None, None]
    for lane in rows:
        assert len(lane) == 3
        for i, f in enumerate(lane):
            ours = np.concatenate([f.y.ravel(), f.cb.ravel(),
                                   f.cr.ravel()])
            assert np.array_equal(ours, golden[i]), f"frame {i} (batch)"


def test_fill_weight_tables_remaps_slice_id():
    mb_w = mb_h = 6
    abi = empty_frame_abi(mb_w, mb_h)
    n = mb_w * mb_h
    # one slice per MB row: 6 rows -> fits; then 36 slices -> remap
    hdrs = [_hdr() for _ in range(n)]          # slice per MB (36 slices)
    abi["slice_id"] = np.arange(n, dtype=np.int32) % n
    fill_weight_tables(abi, _pps(), hdrs, [((), ())] * n, cur_poc=0)
    sid = np.asarray(abi["slice_id"])
    assert (sid == 0).all()
    assert sid.max() < MAX_SLICES - 1
