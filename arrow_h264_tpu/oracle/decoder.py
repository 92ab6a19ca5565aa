"""Oracle decoder driver: Annex-B stream -> YUV frames (numpy path).

Reference parity: JM-lineage `ldecod.c` / `image.c` decode loop
(SURVEY.md §3.2 call stack; reference mount empty — spec 8.2 order).

This is the bring-up + unit-test oracle (SURVEY.md §7 step 1).  The device
pipeline shares the same host entropy layer (mb.parse) and must match this
decoder bit-exactly.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import nal
from ..bitstream.bits import BitReader
from ..bitstream.params import PPS, SPS, parse_pps, parse_sps
from ..bitstream.slicehdr import parse_slice_header
from ..dpb import DPB
from ..mb.parse import PictureParse
from ..mb.types import MB_IPCM
from .deblock import DeblockMeta, deblock_frame
from .reconstruct import Reconstructor


def build_deblock_meta(pic: PictureParse) -> DeblockMeta:
    mb_h, mb_w = pic.mb_h, pic.mb_w
    is_intra = np.zeros((mb_h, mb_w), bool)
    tr8 = np.zeros((mb_h, mb_w), bool)
    qp = np.zeros((mb_h, mb_w), np.int32)
    nz = np.zeros((mb_h, mb_w, 4, 4), bool)
    mv = np.zeros((mb_h, mb_w, 4, 4, 2, 2), np.int32)
    refid = np.full((mb_h, mb_w, 4, 4, 2), -1, np.int32)
    slice_id = np.zeros((mb_h, mb_w), np.int32)
    disable = np.zeros((mb_h, mb_w), np.int32)
    a_off = np.zeros((mb_h, mb_w), np.int32)
    b_off = np.zeros((mb_h, mb_w), np.int32)
    for mb in pic.mbs:
        my, mx = mb.mb_y, mb.mb_x
        is_intra[my, mx] = mb.is_intra
        tr8[my, mx] = mb.transform_8x8
        qp[my, mx] = 0 if mb.category == MB_IPCM else mb.qp
        blk_nz = mb.tc_luma > 0
        if mb.transform_8x8:
            # bS=2 test uses 8x8 coded status when transform_size_8x8 (8.7.2.1)
            for y8 in range(2):
                for x8 in range(2):
                    q = blk_nz[2 * y8:2 * y8 + 2, 2 * x8:2 * x8 + 2].any()
                    blk_nz[2 * y8:2 * y8 + 2, 2 * x8:2 * x8 + 2] = q
        nz[my, mx] = blk_nz
        if mb.mvs is not None:
            mv[my, mx] = np.moveaxis(mb.mvs, 0, 2)  # [y4,x4,list,2]
        if mb.refidx is not None and not mb.is_intra:
            # bS compares PICTURES, not ref indices: map refidx -> DPB uid
            ridx = np.moveaxis(mb.refidx, 0, 2).astype(np.int32)  # [4,4,2]
            l0, l1 = pic.slice_reflists[mb.slice_id]
            for lst, lref in ((0, l0), (1, l1)):
                if len(lref):
                    uids = np.array([p.uid for p in lref], np.int32)
                    r_ = ridx[..., lst]
                    refid[my, mx, :, :, lst] = np.where(
                        r_ >= 0, uids[np.clip(r_, 0, len(uids) - 1)], -1)
        slice_id[my, mx] = mb.slice_id
        hdr = pic.headers[mb.slice_id]
        disable[my, mx] = hdr.disable_deblocking_filter_idc
        a_off[my, mx] = 2 * hdr.slice_alpha_c0_offset_div2
        b_off[my, mx] = 2 * hdr.slice_beta_offset_div2
    return DeblockMeta(
        is_intra=is_intra, tr8=tr8, qp=qp, nz=nz, mv=mv, refid=refid,
        slice_id=slice_id, disable_idc=disable, alpha_off=a_off, beta_off=b_off,
        chroma_qp_off=(pic.pps.chroma_qp_index_offset,
                       pic.pps.chroma_qp_offset(1)),
    )


def crop_planes(sps: SPS, y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    if not sps.frame_cropping_flag:
        return y, cb, cr
    # 4:2:0: CropUnitX = 2; CropUnitY = 2 * (2 - frame_mbs_only_flag)
    # (spec 7.4.2.1.1 — vertical crop units double for interlaced SPS)
    cu_y = 2 * (2 - sps.frame_mbs_only_flag)
    l, r_, t, b = (2 * sps.crop_left, 2 * sps.crop_right,
                   cu_y * sps.crop_top, cu_y * sps.crop_bottom)
    h, w = y.shape
    y = y[t:h - b, l:w - r_]
    cb = cb[t // 2:(h - b) // 2, l // 2:(w - r_) // 2]
    cr = cr[t // 2:(h - b) // 2, l // 2:(w - r_) // 2]
    return y, cb, cr


class OracleDecoder:
    """Decode driver: I/P CAVLC pictures with a full DPB (configs 1-2)."""

    def __init__(self) -> None:
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self.dpb: DPB | None = None
        self._dpb_sps_id: int | None = None

    def decode_annexb(self, data: bytes):
        """Yield (y, cb, cr) uint8 planes in output order."""
        cur_pic: PictureParse | None = None
        cur_poc = 0
        for u in nal.parse_annexb(data):
            if u.nal_unit_type == nal.NAL_SPS:
                s = parse_sps(u.rbsp)
                if s.qpprime_y_zero_transform_bypass_flag:
                    # lossless bypass is decoded by the shipped pipeline
                    # (ops.transforms bypass=True); this numpy oracle
                    # would silently apply the normal transform
                    raise NotImplementedError(
                        "OracleDecoder does not decode lossless bypass "
                        "streams; use arrow_h264_tpu.api.Decoder")
                self.sps_map[s.seq_parameter_set_id] = s
            elif u.nal_unit_type == nal.NAL_PPS:
                p = parse_pps(u.rbsp, self.sps_map)
                self.pps_map[p.pic_parameter_set_id] = p
            elif u.is_slice:
                r = BitReader(u.rbsp)
                r2 = BitReader(u.rbsp)
                r2.ue()
                r2.ue()
                pps = self.pps_map[r2.ue()]
                sps = self.sps_map[pps.seq_parameter_set_id]
                hdr = parse_slice_header(r, sps, pps, u.nal_unit_type,
                                         u.nal_ref_idc)
                if hdr.first_mb_in_slice == 0:
                    if cur_pic is not None:
                        yield from self._finish_picture(cur_pic, cur_poc)
                    if self.dpb is None or self._dpb_sps_id != \
                            sps.seq_parameter_set_id:
                        self.dpb = DPB(sps)
                        self._dpb_sps_id = sps.seq_parameter_set_id
                    cur_pic = PictureParse(sps, pps)
                    cur_poc = self.dpb.compute_poc(hdr)
                if cur_pic is None:
                    raise ValueError("slice without picture start")
                reflists = ((), ())
                if hdr.is_p:
                    reflists = (self.dpb.init_list_p(hdr), ())
                elif hdr.is_b:
                    reflists = self.dpb.init_lists_b(hdr, cur_poc)
                cur_pic.parse_slice(r, hdr, reflists, cur_poc)
        if cur_pic is not None:
            yield from self._finish_picture(cur_pic, cur_poc)
        if self.dpb is not None:
            for planes in self.dpb.flush():
                yield self._emit(planes)

    def _finish_picture(self, pic: PictureParse, poc: int):
        y, cb, cr = Reconstructor(pic, poc).run()
        y = y.astype(np.uint8)
        cb = cb.astype(np.uint8)
        cr = cr.astype(np.uint8)
        meta = build_deblock_meta(pic)
        deblock_frame(y, cb, cr, meta)
        hdr = pic.headers[0]
        outputs, stored = self.dpb.store((y, cb, cr, pic.sps), hdr, poc)
        if stored.is_ref:
            stored.col_mv, stored.col_refidx, stored.col_ref_uid = \
                pic.build_col_motion()
        for planes in outputs:
            yield self._emit(planes)

    @staticmethod
    def _emit(planes):
        y, cb, cr, sps = planes
        return crop_planes(sps, y, cb, cr)
