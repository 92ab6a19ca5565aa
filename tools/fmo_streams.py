"""Hand-authored FMO / ASO conformance streams (test infrastructure).

x264 cannot encode FMO, and the container has no JM conformance set
(zero egress), so the FMO decode path (SURVEY.md §2 "FMO / ASO" row;
spec 8.2.2) is exercised with bit-exact hand-authored Baseline CAVLC
streams: one I_PCM picture per frame, one slice per slice group, each
slice walking its group's MBs in NextMbAddress order.  I_PCM carries
the pixels verbatim, so the authored content is fully deterministic
while still exercising the FMO-specific machinery end to end: PPS
slice-group syntax, per-slice map derivation (incl. the changing types'
slice_group_change_cycle), decode-order MB iteration, picture
assembly across interleaved slices, ASO, and deblocking with per-MB
slice ids.  The golden oracle is the system libavcodec
(tools.streams.golden_decode), same as every other conformance test.
"""

from __future__ import annotations

import numpy as np

from arrow_h264_tpu.bitstream.bits import BitWriter
from arrow_h264_tpu.bitstream.fmo import mb_slice_group_map
from arrow_h264_tpu.bitstream.nal import rbsp_to_ebsp
from arrow_h264_tpu.bitstream.params import PPS, SPS, write_pps, write_sps
from arrow_h264_tpu.bitstream.slicehdr import SliceHeader, write_slice_header


def _nal(nal_unit_type: int, nal_ref_idc: int, rbsp: bytes) -> bytes:
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    return b"\x00\x00\x00\x01" + hdr + rbsp_to_ebsp(rbsp)


def _pcm_mb(addr: int, frame: int, mb_w: int) -> tuple[np.ndarray, ...]:
    """Deterministic PCM samples for one MB (y [16,16], cb/cr [8,8])."""
    rng = np.random.default_rng(1000 * frame + addr)
    y = rng.integers(16, 236, (16, 16)).astype(np.uint8)
    cb = rng.integers(16, 240, (8, 8)).astype(np.uint8)
    cr = rng.integers(16, 240, (8, 8)).astype(np.uint8)
    return y, cb, cr


def _write_pcm_samples(w: BitWriter, y, cb, cr) -> None:
    while not w.byte_aligned():          # pcm_alignment_zero_bit
        w.put_bit(0)
    for arr in (y, cb, cr):
        for v in arr.ravel():
            w.u(int(v), 8)


def make_fmo_stream(pps_kwargs: dict, n_frames: int = 2,
                    mb_w: int = 11, mb_h: int = 9,
                    slice_order=None, change_cycle: int = 0) -> bytes:
    """Authored Annex-B stream: IDR + n_frames-1 more I pictures, all
    I_PCM, one slice per slice group.  slice_order permutes the slices
    within each picture (ASO); change_cycle feeds map types 3..5."""
    sps = SPS(profile_idc=66, level_idc=20, pic_width_in_mbs=mb_w,
              pic_height_in_map_units=mb_h, max_num_ref_frames=1)
    pps = PPS(**pps_kwargs)
    out = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps))]
    n = mb_w * mb_h
    sgmap = mb_slice_group_map(sps, pps, change_cycle)
    groups = sorted(set(sgmap.tolist()))
    order = slice_order if slice_order is not None else groups
    for f in range(n_frames):
        for g in order:
            members = np.flatnonzero(sgmap == g)
            if not len(members):
                continue
            w = BitWriter()
            hdr = SliceHeader(
                first_mb_in_slice=int(members[0]), slice_type=7 % 5,
                frame_num=0 if f == 0 else f % (1 << sps.log2_max_frame_num),
                idr_pic_id=0, pic_order_cnt_lsb=(2 * f) %
                    (1 << sps.log2_max_pic_order_cnt_lsb),
                slice_qp_delta=0)
            hdr.is_idr = f == 0
            hdr.nal_ref_idc = 3
            hdr.slice_group_change_cycle = change_cycle
            # IDR slice_type signalled as 7 (I, all-slices-same flavor)
            hdr.slice_type = 2
            write_slice_header(w, hdr, sps, pps)
            for addr in members:
                w.ue(25)                 # mb_type I_PCM
                _write_pcm_samples(w, *_pcm_mb(int(addr), f, mb_w))
            w.rbsp_trailing_bits()
            out.append(_nal(5 if f == 0 else 1, 3, w.get_bytes()))
    return b"".join(out)


def pcm_golden(pps_kwargs: dict, n_frames: int = 2,
               mb_w: int = 11, mb_h: int = 9,
               change_cycle: int = 0) -> list[np.ndarray]:
    """Spec-exact decode of make_fmo_stream's output, constructed
    directly: I_PCM carries pixels verbatim and PCM MBs deblock with
    QPY = 0 where alpha(0) = beta(0) = 0 disables every edge filter
    (spec 8.7.2), so the decoded picture IS the authored PCM content.
    (libavcodec cannot decode FMO, so this constructed golden stands in
    for golden_decode; the map formulas are unit-pinned separately.)"""
    out = []
    for f in range(n_frames):
        y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
        cb = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
        cr = np.zeros_like(cb)
        for addr in range(mb_w * mb_h):
            my, mx = divmod(addr, mb_w)
            ym, cbm, crm = _pcm_mb(addr, f, mb_w)
            y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = ym
            cb[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = cbm
            cr[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = crm
        out.append(np.concatenate([y.ravel(), cb.ravel(), cr.ravel()]))
    return out


# (pps_kwargs, change_cycle) per FMO scenario; QCIF-class 11x9 geometry
SCENARIOS = {
    "interleave_t0": (dict(num_slice_groups=2, slice_group_map_type=0,
                           run_length=[3, 5]), 0),
    "dispersed_t1": (dict(num_slice_groups=3, slice_group_map_type=1), 0),
    "fg_bg_t2": (dict(num_slice_groups=2, slice_group_map_type=2,
                      top_left=[13], bottom_right=[41]), 0),
    "boxout_t3": (dict(num_slice_groups=2, slice_group_map_type=3,
                       slice_group_change_direction_flag=0,
                       slice_group_change_rate=7), 4),
    "raster_t4": (dict(num_slice_groups=2, slice_group_map_type=4,
                       slice_group_change_direction_flag=1,
                       slice_group_change_rate=11), 3),
    "wipe_t5": (dict(num_slice_groups=2, slice_group_map_type=5,
                     slice_group_change_direction_flag=0,
                     slice_group_change_rate=9), 5),
    "explicit_t6": (dict(num_slice_groups=2, slice_group_map_type=6,
                         slice_group_id=[i % 2 for i in range(99)]), 0),
}


# ---------------------------------------------------------------------------
# FMO with REAL syntax: CAVLC residual + P-slice content.
#
# libavcodec cannot decode FMO, so the oracle is indirect but still
# independent: each FMO stream is authored together with a RASTER TWIN —
# a num_slice_groups=1 stream carrying the IDENTICAL per-MB content whose
# slices are cut at every slice-group row boundary.  With row-based group
# maps the neighbor-availability pattern (spec 6.4: a neighbor in a
# different slice is unavailable) is then EXACTLY equal in both streams:
# left neighbors share the row (same slice both ways), top neighbors are
# available iff the row above is in the same group (FMO) iff it is in
# the same row-run slice (twin).  Equal availability + equal content =>
# bit-identical decoded YUV, while the CAVLC nC contexts, skip runs and
# MV predictions are parsed through completely different slice
# structures.  The twin decodes through libavcodec (golden_decode), so a
# shared encoder/decoder bug cannot hide: a wrong nC model in the
# authoring below would break the twin against libavcodec first.

_ZBLK = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
         (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]


def _mb_plan(addr: int, frame: int) -> tuple:
    """Deterministic per-MB syntax plan shared by both streams."""
    rng = np.random.default_rng(7000 + 97 * frame + addr)
    if frame == 0:
        dc = np.zeros(16, np.int64)
        k = int(rng.integers(1, 5))
        pos = np.sort(rng.choice(16, k, replace=False))
        dc[pos] = rng.integers(1, 4, k) * rng.choice([-1, 1], k)
        if addr % 3 == 2:                    # cbpY=0: DC-only MBs
            return ("I16", dc, None)
        ac = np.zeros((16, 15), np.int64)    # cbpY=15: dense AC
        for b in range(16):
            kb = int(rng.integers(0, 5))
            if kb:
                p = np.sort(rng.choice(15, kb, replace=False))
                ac[b][p] = rng.integers(1, 3, kb) * rng.choice([-1, 1], kb)
        return ("I16", dc, ac)
    m = addr % 5
    if m in (0, 2):
        return ("SKIP",)
    if m == 3:                               # intra-in-P, DC-only
        dc = np.zeros(16, np.int64)
        dc[int(rng.integers(0, 16))] = int(rng.integers(1, 4))
        return ("PI16", dc, None)
    return ("P16", (int(rng.integers(-8, 9)), int(rng.integers(-8, 9))))


class _CavlcPicState:
    """Per-picture nC bookkeeping with slice-aware availability."""

    def __init__(self, mb_w: int, mb_h: int, slice_of: np.ndarray):
        self.mb_w = mb_w
        self.nz = np.zeros((mb_h * 4, mb_w * 4), np.int32)
        self.slice_of = slice_of             # [n] slice id per MB

    def nc(self, addr: int, by: int, bx: int) -> int:
        sid = self.slice_of[addr]

        def get(y, x):
            if y < 0 or x < 0:
                return None
            a2 = (y // 4) * self.mb_w + (x // 4)
            if self.slice_of[a2] != sid:
                return None                  # different slice: unavailable
            return int(self.nz[y, x])

        nA = get(by, bx - 1)
        nB = get(by - 1, bx)
        if nA is not None and nB is not None:
            return (nA + nB + 1) >> 1
        if nA is not None:
            return nA
        if nB is not None:
            return nB
        return 0


def _emit_mb(w: BitWriter, st: _CavlcPicState, addr: int, plan: tuple,
             in_p_slice: bool) -> None:
    from arrow_h264_tpu.entropy.cavlc import encode_residual_block
    my, mx = divmod(addr, st.mb_w)
    by0, bx0 = my * 4, mx * 4
    if plan[0] in ("I16", "PI16"):
        _tag, dc, ac = plan
        icode = 3 if ac is None else 15      # pred DC, cbpC 0, cbpY 0/15
        w.ue((5 + icode) if in_p_slice else icode)
        w.ue(0)                              # intra_chroma_pred_mode DC
        w.se(0)                              # mb_qp_delta
        encode_residual_block(w, st.nc(addr, by0, bx0), list(dc), 16)
        if ac is not None:
            for b, (dy, dx) in enumerate(_ZBLK):
                tc, _ = encode_residual_block(
                    w, st.nc(addr, by0 + dy, bx0 + dx), list(ac[b]), 15)
                st.nz[by0 + dy, bx0 + dx] = tc
        return
    assert plan[0] == "P16"
    w.ue(0)                                  # P_L0_16x16
    w.se(plan[1][0])                         # mvd_l0 x
    w.se(plan[1][1])                         # mvd_l0 y
    w.ue(0)                                  # cbp 0 (inter me: codeNum 0)


def _write_cavlc_slice(st: _CavlcPicState, members, plans, sps, pps,
                       frame: int, slice_type: int) -> bytes:
    w = BitWriter()
    hdr = SliceHeader(
        first_mb_in_slice=int(members[0]), slice_type=slice_type,
        frame_num=frame % (1 << sps.log2_max_frame_num),
        idr_pic_id=0,
        pic_order_cnt_lsb=(2 * frame) % (1 << sps.log2_max_pic_order_cnt_lsb),
        slice_qp_delta=0)
    hdr.is_idr = frame == 0
    hdr.nal_ref_idc = 3
    write_slice_header(w, hdr, sps, pps)
    is_p = slice_type == 0
    skip_run = 0
    for addr in members:
        plan = plans[addr]
        if is_p and plan[0] == "SKIP":
            skip_run += 1
            continue
        if is_p:
            w.ue(skip_run)
            skip_run = 0
        _emit_mb(w, st, int(addr), plan, is_p)
    if is_p and skip_run:
        w.ue(skip_run)
    w.rbsp_trailing_bits()
    return _nal(5 if frame == 0 else 1, 3, w.get_bytes())


def make_fmo_cavlc_pair(map_kind: str, mb_w: int = 8, mb_h: int = 6,
                        n_frames: int = 2) -> tuple[bytes, bytes]:
    """(fmo_stream, raster_twin) with identical per-MB CAVLC content.

    map_kind: "interleave" (type 0, alternating rows) or "explicit"
    (type 6, an irregular per-row group pattern incl. adjacent
    same-group rows).  Frame 0 is IDR all-intra (I16 DC+AC residuals);
    frames 1.. are P (skips, P_L0_16x16 with mvd, intra-in-P)."""
    n = mb_w * mb_h
    sps = SPS(profile_idc=66, level_idc=20, pic_width_in_mbs=mb_w,
              pic_height_in_map_units=mb_h, max_num_ref_frames=1)
    if map_kind == "interleave":
        row_group = [r % 2 for r in range(mb_h)]
        pps_fmo = PPS(num_slice_groups=2, slice_group_map_type=0,
                      run_length=[mb_w, mb_w])
    elif map_kind == "explicit":
        pat = [0, 0, 1, 0, 1, 1, 0, 1]
        row_group = [pat[r % len(pat)] for r in range(mb_h)]
        pps_fmo = PPS(num_slice_groups=2, slice_group_map_type=6,
                      slice_group_id=[row_group[i // mb_w]
                                      for i in range(n)])
    else:
        raise ValueError(map_kind)
    pps_ras = PPS()
    sgmap = mb_slice_group_map(sps, pps_fmo, 0)
    assert sgmap.tolist() == [row_group[i // mb_w] for i in range(n)]

    # slice memberships: FMO = one slice per group (NextMbAddress order);
    # twin = one slice per run of consecutive same-group rows
    groups = sorted(set(row_group))
    fmo_slices = [np.flatnonzero(sgmap == g) for g in groups]
    fmo_sid = np.zeros(n, np.int32)
    for s, mem in enumerate(fmo_slices):
        fmo_sid[mem] = s
    runs, r0 = [], 0
    for r in range(1, mb_h + 1):
        if r == mb_h or row_group[r] != row_group[r - 1]:
            runs.append((r0, r))
            r0 = r
    ras_slices = [np.arange(a * mb_w, b * mb_w) for a, b in runs]
    ras_sid = np.zeros(n, np.int32)
    for s, mem in enumerate(ras_slices):
        ras_sid[mem] = s

    out_fmo = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps_fmo))]
    out_ras = [_nal(7, 3, write_sps(sps)), _nal(8, 3, write_pps(pps_ras))]
    for f in range(n_frames):
        plans = {a: _mb_plan(a, f) for a in range(n)}
        stype = 2 if f == 0 else 0
        st = _CavlcPicState(mb_w, mb_h, fmo_sid)
        for mem in fmo_slices:
            out_fmo.append(_write_cavlc_slice(st, mem, plans, sps, pps_fmo,
                                              f, stype))
        st = _CavlcPicState(mb_w, mb_h, ras_sid)
        for mem in ras_slices:
            out_ras.append(_write_cavlc_slice(st, mem, plans, sps, pps_ras,
                                              f, stype))
    return b"".join(out_fmo), b"".join(out_ras)
