"""Device inter prediction: quarter-pel MC over precomputed half-pel planes.

Reference parity: JM-lineage `get_block.c` quarter-pel interpolation +
`mc_prediction.c` weighted prediction (SURVEY.md §2), restructured for a
batched accelerator: instead of per-block 6-tap windows, each reference
picture's
half-pel planes (b = horizontal, h = vertical, j = diagonal) are computed
ONCE when the picture is stored into the device DPB — dense separable
filtering that vectorizes perfectly — and per-block MC reduces to at most
two single-pixel gathers plus an average (the spec's quarter-pel position
table, 8.4.2.2.1).

The planes are edge-padded by PAD with clamp semantics, which is exactly
the spec's unrestricted-MV edge extension (see oracle.inter).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PAD = 32            # luma padding; chroma uses PAD // 2
PADC = PAD // 2

# MC envelope of the host-side mode selection
# (models.pipeline.select_inter_mode): distinct DPB slots per frame,
# distinct (slot, dy, dx) candidates per 16-row band, integer-pel MV
# bounds.  The device gather path itself takes any MV and any slot.
CAP = 61
MAX_SLOTS = 4
DY_MIN, DY_MAX = -20, 20
DX_MIN, DX_MAX = -30, 30


# ---------------------------------------------------------------------------
# packed DPB layout: u8 pixels four to a little-endian u32 word
# ---------------------------------------------------------------------------

def luma_lanes(W: int) -> int:
    """u32 words per padded luma row."""
    return -(-(W + 2 * PAD) // 4)


def chroma_lanes(W: int) -> int:
    """u32 words per padded chroma row (W is the luma width)."""
    return -(-(W // 2 + 2 * PADC) // 4)


def chroma_rows(H: int) -> int:
    """Padded chroma plane rows (H is the luma height)."""
    return H // 2 + 2 * PADC


def pack_u8_plane(p, n_lanes: int):
    """u8 [H, Wpx] -> packed u32 [H, n_lanes] (little-endian 4px/lane)."""
    H, Wpx = p.shape
    pad = n_lanes * 4 - Wpx
    x = jnp.pad(p, ((0, 0), (0, pad))).reshape(H, n_lanes, 4)
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _tap6_1d(v, axis):
    """6-tap (1,-5,20,20,-5,1) along axis; output length = len - 5."""
    taps = (1, -5, 20, 20, -5, 1)
    n = v.shape[axis]
    sl = lambda k: jax.lax.slice_in_dim(v, k, n - 5 + k, axis=axis)
    return sum(c * sl(k) for k, c in enumerate(taps))


def halfpel_planes(y_plane):
    """[H, W] uint8 (unpadded) -> (G, b, h, j) [Hp, Wp] uint8 padded planes.

    G is the padded integer plane; b/h/j are the spec 8.4.2.2.1 half-pels
    aligned so that plane[y + PAD, x + PAD] is the half-pel sample at
    integer position (x, y) (i.e. b at (x+0.5, y), h at (x, y+0.5),
    j at (x+0.5, y+0.5)).
    """
    yi = jnp.pad(y_plane, PAD + 3, mode="edge").astype(jnp.int32)
    # b: horizontal 6-tap at (x+0.5): taps over x-2..x+3
    b1 = _tap6_1d(yi, 1)                    # [Hp+6, Wp+1]
    b = jnp.clip((b1 + 16) >> 5, 0, 255)[3:-3, 1:]
    # h: vertical 6-tap
    h1 = _tap6_1d(yi, 0)                    # [Hp+1, Wp+6]
    h = jnp.clip((h1 + 16) >> 5, 0, 255)[1:, 3:-3]
    # j: vertical 6-tap of b1 intermediates
    j1 = _tap6_1d(b1, 0)                    # [Hp+1, Wp+1]
    j = jnp.clip((j1 + 512) >> 10, 0, 255)[1:, 1:]
    G = yi[3:-3, 3:-3]
    return (G.astype(jnp.uint8), b.astype(jnp.uint8),
            h.astype(jnp.uint8), j.astype(jnp.uint8))


def pad_chroma(p):
    return jnp.pad(p, PAD // 2, mode="edge")


# plane/offset table per (yf, xf): (plane1, dy1, dx1, plane2, dy2, dx2)
# planes: 0 G, 1 b, 2 h, 3 j  (spec 8.4.2.2.1 quarter-pel positions)
_LUMA_TAB = [
    # yf = 0
    [0, 0, 0, 0, 0, 0], [0, 0, 0, 1, 0, 0], [1, 0, 0, 1, 0, 0],
    [1, 0, 0, 0, 0, 1],
    # yf = 1
    [0, 0, 0, 2, 0, 0], [1, 0, 0, 2, 0, 0], [1, 0, 0, 3, 0, 0],
    [1, 0, 0, 2, 0, 1],
    # yf = 2
    [2, 0, 0, 2, 0, 0], [2, 0, 0, 3, 0, 0], [3, 0, 0, 3, 0, 0],
    [3, 0, 0, 2, 0, 1],
    # yf = 3
    [0, 1, 0, 2, 0, 0], [1, 1, 0, 2, 0, 0], [3, 0, 0, 1, 1, 0],
    [1, 1, 0, 2, 0, 1],
]


def _luma_gather_core(fetch, Hp, Wp, slot, bx, by, mvx, mvy):
    """Quarter-pel luma MC over a pixel-fetch closure.

    fetch(slot3, plane3, yy, xx) -> int32 pixels; indices pre-clamped to
    [0, Hp-1] x [0, Wp-1] (clamp == spec edge extension given the planes
    are PAD edge-padded).  Returns [N, 4, 4] int32.

    Position table: out = (P1 + P2 + 1) >> 1 with plane and offset
    selection by (xFrac, yFrac); full/half positions use P1 == P2.
    """
    xi = bx + (mvx >> 2) + PAD
    yi = by + (mvy >> 2) + PAD
    xf = mvx & 3
    yf = mvy & 3
    table = jnp.asarray(_LUMA_TAB, jnp.int32)   # [16, 6]
    sel = table[yf * 4 + xf]                    # [N, 6]
    ys = jnp.arange(4)
    xs = jnp.arange(4)

    def gather(plane_idx, dy, dx):
        yy = jnp.clip(yi[:, None] + dy[:, None] + ys[None, :], 0, Hp - 1)
        xx = jnp.clip(xi[:, None] + dx[:, None] + xs[None, :], 0, Wp - 1)
        return fetch(slot[:, None, None], plane_idx[:, None, None],
                     yy[:, :, None], xx[:, None, :])

    p1 = gather(sel[:, 0], sel[:, 1], sel[:, 2])
    p2 = gather(sel[:, 3], sel[:, 4], sel[:, 5])
    same = (sel[:, 0] == sel[:, 3]) & (sel[:, 1] == sel[:, 4]) & \
        (sel[:, 2] == sel[:, 5])
    avg = (p1 + p2 + 1) >> 1
    return jnp.where(same[:, None, None], p1, avg)


def luma_mc_gather_packed(dpb_y4p, Wpx, slot, bx, by, mvx, mvy):
    """Quarter-pel MC gathering DIRECTLY from the packed u32 DPB planes
    (dpb_y4p [S, 4, Hp, L], little-endian 4 px/lane — models.pipeline's
    device DPB layout).  Gathering the u32 word and extracting the byte
    avoids materializing a dense unpacked DPB as the gather operand
    (~55 MB/slot-set per stream, multiplied by the batch).  Wpx: real
    pixel width (L*4 may exceed it; the lane-rounding columns are
    garbage, so clamp happens in PIXEL space)."""
    Hp = dpb_y4p.shape[2]

    def fetch(s, p, yy, xx):
        w = dpb_y4p[s, p, yy, xx >> 2]
        sh = ((xx & 3) << 3).astype(jnp.uint32)
        return ((w >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)

    return _luma_gather_core(fetch, Hp, Wpx, slot, bx, by, mvx, mvy)


def _chroma_gather_core(fetch, Hp, Wp, slot, bx, by, mvx, mvy):
    """1/8-pel bilinear chroma MC for N 2x2 blocks via 4 pixel gathers."""
    xi = bx + (mvx >> 3) + PADC
    yi = by + (mvy >> 3) + PADC
    xf = (mvx & 7)[:, None, None]
    yf = (mvy & 7)[:, None, None]
    ys = jnp.arange(2)
    xs = jnp.arange(2)

    def g(dy, dx):
        yy = jnp.clip(yi[:, None] + ys[None, :] + dy, 0, Hp - 1)
        xx = jnp.clip(xi[:, None] + xs[None, :] + dx, 0, Wp - 1)
        return fetch(slot[:, None, None], yy[:, :, None], xx[:, None, :])

    A = g(0, 0)
    B = g(0, 1)
    C = g(1, 0)
    D = g(1, 1)
    return ((8 - xf) * (8 - yf) * A + xf * (8 - yf) * B +
            (8 - xf) * yf * C + xf * yf * D + 32) >> 6


def chroma_mc_blocks_packed(dpb_cp1, Hpx, Wpx, slot, bx, by, mvx, mvy):
    """Chroma MC from ONE packed plane [S, Hp, L] u32 (4 px/lane).
    Hpx/Wpx: real padded extents (lane rounding can exceed them with
    garbage; clamp in pixel space)."""
    def fetch(s, yy, xx):
        w = dpb_cp1[s, yy, xx >> 2]
        sh = ((xx & 3) << 3).astype(jnp.uint32)
        return ((w >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)

    return _chroma_gather_core(fetch, Hpx, Wpx, slot, bx, by, mvx, mvy)


def weight_uni_dev(pred, w, o, log_wd):
    """Explicit unidirectional weighting (8.4.2.3.2); unit params = identity."""
    hi = ((pred * w + (1 << jnp.maximum(log_wd - 1, 0))) >> log_wd) + o
    lo = pred * w + o
    return jnp.clip(jnp.where(log_wd >= 1, hi, lo), 0, 255)


def weight_bi_dev(p0, p1, w0, w1, o0, o1, log_wd):
    """Weighted bi-prediction; (1,1,0,0,0) degenerates to default averaging."""
    v = ((p0 * w0 + p1 * w1 + (1 << log_wd)) >> (log_wd + 1)) + \
        ((o0 + o1 + 1) >> 1)
    return jnp.clip(v, 0, 255)


def inter_predict_cells_packed(abi, dpb_y4p, dpb_cp, blk, mb_w: int,
                               mb_h: int):
    """Weighted MC of the cells `blk` off the packed DPB: dpb_y4p
    [S,4,Hp,L] u32, dpb_cp [S,2,Hcp,Lc] u32 (models.pipeline.dpb_alloc
    layout) — no dense unpack anywhere."""
    Wy = mb_w * 16 + 2 * PAD
    Hc = mb_h * 8 + 2 * PADC
    Wc = mb_w * 8 + 2 * PADC
    return _inter_cells_core(
        abi, blk, mb_w,
        functools.partial(luma_mc_gather_packed, dpb_y4p, Wy),
        functools.partial(chroma_mc_blocks_packed, dpb_cp[:, 0], Hc, Wc),
        functools.partial(chroma_mc_blocks_packed, dpb_cp[:, 1], Hc, Wc))


def _inter_cells_core(abi, blk, mb_w: int, luma_g, chroma_gb, chroma_gr):
    """Weighted quarter-pel MC for an arbitrary LIST of 4x4 cells.

    blk [K] i32: flat cell indices (mb * 16 + raster cell); the frame
    paths pass arange(n*16).  Returns (y [K,4,4], cb [K,2,2],
    cr [K,2,2]) i32.
    """
    n16 = abi["mv"].shape[0] * 16
    mv = abi["mv"].reshape(n16, 2, 2)[blk]          # [K, list, (x, y)]
    refslot = abi["refslot"].reshape(n16, 2)[blk]
    used = refslot >= 0
    slot = jnp.maximum(refslot, 0)
    mbi = blk // 16
    cell = blk % 16
    mbx = mbi % mb_w
    mby = mbi // mb_w
    bx = mbx * 16 + (cell % 4) * 4
    by = mby * 16 + (cell // 4) * 4
    cx = mbx * 8 + (cell % 4) * 2
    cy = mby * 8 + (cell // 4) * 2

    # PAFF cross-parity chroma adjustment (spec 8.4.1.4.1): when the
    # current FIELD references a field of opposite parity, the vertical
    # CHROMA vector shifts by +-2 (1/8 chroma-sample units — the same
    # units this core reads mv[..,1] in for chroma).  abi["cvoff"] is a
    # per-device-DPB-slot table (0 for same parity / frame decoding).
    cvoff = abi.get("cvoff")
    preds_y = []
    preds_cb = []
    preds_cr = []
    for lst in range(2):
        mvy_c = mv[:, lst, 1]
        if cvoff is not None:
            mvy_c = mvy_c + cvoff[slot[:, lst]]
        py = luma_g(slot[:, lst], bx, by, mv[:, lst, 0], mv[:, lst, 1])
        pcb = chroma_gb(slot[:, lst], cx, cy, mv[:, lst, 0], mvy_c)
        pcr = chroma_gr(slot[:, lst], cx, cy, mv[:, lst, 0], mvy_c)
        preds_y.append(py)
        preds_cb.append(pcb)
        preds_cr.append(pcr)

    wp = abi["wp"]                                   # [n,4,4,2,3,2]
    wpf = wp.reshape(n16, 2, 3, 2)[blk]
    logwd_y = abi["logwd"][:, 0][mbi]                # [K]
    logwd_c = abi["logwd"][:, 1][mbi]

    def combine(p0, p1, plane_idx, logwd):
        w0 = wpf[:, 0, plane_idx, 0][:, None, None]
        o0 = wpf[:, 0, plane_idx, 1][:, None, None]
        w1 = wpf[:, 1, plane_idx, 0][:, None, None]
        o1 = wpf[:, 1, plane_idx, 1][:, None, None]
        lw = logwd[:, None, None]
        both = (used[:, 0] & used[:, 1])[:, None, None]
        only1 = (~used[:, 0])[:, None, None]
        uni0 = weight_uni_dev(p0, w0, o0, lw)
        uni1 = weight_uni_dev(p1, w1, o1, lw)
        bi = weight_bi_dev(p0, p1, w0, w1, o0, o1, lw)
        return jnp.where(both, bi, jnp.where(only1, uni1, uni0))

    out_y = combine(preds_y[0], preds_y[1], 0, logwd_y)
    out_cb = combine(preds_cb[0], preds_cb[1], 1, logwd_c)
    out_cr = combine(preds_cr[0], preds_cr[1], 2, logwd_c)
    return out_y, out_cb, out_cr


def inter_predict_packed(abi, dpb_y4p, dpb_cp, mb_w: int, mb_h: int):
    """Full-frame gather MC straight off the packed device DPB."""
    n = mb_w * mb_h
    out_y, out_cb, out_cr = inter_predict_cells_packed(
        abi, dpb_y4p, dpb_cp, jnp.arange(n * 16), mb_w, mb_h)
    return _cells_to_planes(out_y, out_cb, out_cr, mb_w, mb_h)


def _cells_to_planes(out_y, out_cb, out_cr, mb_w: int, mb_h: int):
    n = mb_w * mb_h
    from .transforms import blocks4_to_plane
    pred_y = blocks4_to_plane(out_y.reshape(n, 16, 4, 4), mb_w, mb_h)
    pcb_mb = out_cb.reshape(n, 4, 4, 2, 2).transpose(0, 1, 3, 2, 4).reshape(n, 8, 8)
    pcr_mb = out_cr.reshape(n, 4, 4, 2, 2).transpose(0, 1, 3, 2, 4).reshape(n, 8, 8)
    pred_cb = pcb_mb.reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(mb_h * 8, mb_w * 8)
    pred_cr = pcr_mb.reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(mb_h * 8, mb_w * 8)
    return pred_y, pred_cb, pred_cr
