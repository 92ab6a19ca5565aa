"""Hand-authored many-slice weighted-prediction conformance streams.

A low-latency encoder may emit one slice per MB row with DISTINCT
pred-weight tables per slice (spec 7.3.3.2 pred_weight_table is per
slice header).  At >15 truly distinct parameter sets the device's fixed
weight-table rows overflow and the decoder falls back to dense per-cell
weights (ops.abi._fill_dense_weights).  x264 never emits
per-slice-distinct weights, so the overflow path is exercised with
hand-authored Main-profile streams; libavcodec decodes weighted P
slices, so tools.streams.golden_decode is a true independent oracle.
"""

from __future__ import annotations

import numpy as np

from arrow_h264_tpu.bitstream.bits import BitWriter
from arrow_h264_tpu.bitstream.params import PPS, SPS, write_pps, write_sps
from arrow_h264_tpu.bitstream.slicehdr import (
    PredWeight, SliceHeader, write_slice_header,
)

from tools.fmo_streams import _nal, _pcm_mb, _write_pcm_samples


def make_many_weight_slices_stream(mb_w: int = 4, mb_h: int = 18,
                                   n_p: int = 2) -> bytes:
    """IDR (all-PCM) + n_p P pictures, one slice per MB row, every slice
    carrying a DISTINCT pred-weight table (mb_h > 15 forces the dense
    per-cell weight fallback).  P MBs are P_L0_16x16 with small MVDs and
    no residual, so a wrong weight/offset on any slice breaks
    byte-equality against the libavcodec golden."""
    assert mb_h > 15, "needs enough rows to overflow the slice rows"
    sps = SPS(profile_idc=77, level_idc=30, pic_width_in_mbs=mb_w,
              pic_height_in_map_units=mb_h, max_num_ref_frames=1,
              log2_max_frame_num=4, log2_max_pic_order_cnt_lsb=6)
    pps = PPS(weighted_pred_flag=1)
    out = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps))]
    n = mb_w * mb_h

    w = BitWriter()
    hdr = SliceHeader(first_mb_in_slice=0, slice_type=2, frame_num=0,
                      idr_pic_id=0, pic_order_cnt_lsb=0, slice_qp_delta=0)
    hdr.is_idr = True
    hdr.nal_ref_idc = 3
    write_slice_header(w, hdr, sps, pps)
    for addr in range(n):
        w.ue(25)                                   # I_PCM
        _write_pcm_samples(w, *_pcm_mb(addr, 0, mb_w))
    w.rbsp_trailing_bits()
    out.append(_nal(5, 3, w.get_bytes()))

    for f in range(1, n_p + 1):
        for row in range(mb_h):
            w = BitWriter()
            hdr = SliceHeader(first_mb_in_slice=row * mb_w, slice_type=0,
                              frame_num=f % 16,
                              pic_order_cnt_lsb=(2 * f) % 64,
                              slice_qp_delta=0)
            hdr.is_idr = False
            hdr.nal_ref_idc = 3
            hdr.luma_log2_weight_denom = 5
            hdr.chroma_log2_weight_denom = 5
            lw = 24 + ((7 * row + f) % 17)         # distinct per slice
            lo = (row % 7) - 3
            cw = 30 + (row % 5)
            co = ((3 * row) % 9) - 4
            hdr.pred_weights_l0 = [
                PredWeight(lw, lo, (cw, 64 - cw), (co, -co))]
            write_slice_header(w, hdr, sps, pps)
            rng = np.random.default_rng(900 + 16 * f + row)
            for _ in range(mb_w):
                w.ue(0)                            # mb_skip_run
                w.ue(0)                            # P_L0_16x16
                w.se(int(rng.integers(-6, 7)))     # mvd x
                w.se(int(rng.integers(-6, 7)))     # mvd y
                w.ue(0)                            # cbp 0
            w.rbsp_trailing_bits()
            out.append(_nal(1, 3, w.get_bytes()))
    return b"".join(out)
