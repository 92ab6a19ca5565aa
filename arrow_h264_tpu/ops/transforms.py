"""Device residual pipeline: batched dequant + inverse transforms (JAX).

Reference parity: JM-lineage `transform.c`/`quant.c` inner loops, re-expressed
as whole-frame batched tensor ops (SURVEY.md §1 L4).  Bit-exact vs
oracle.transforms by construction: same integer formulas, arithmetic shifts.

All functions are jit-safe; `ws*` constants come from make_ws_consts and are
ALREADY LevelScale (weightScale x normAdjust, spec 8.5.9).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..common.tables import CHROMA_QP_TABLE, NORM_ADJUST_4x4, NORM_ADJUST_8x8
from .abi import KIND_I16, KIND_IPCM

_CQP = np.asarray(CHROMA_QP_TABLE, np.int32)


def dequant4x4_dev(c, qp, level_scale):
    """Spec 8.5.12.1.  c [..., 4,4] int32, qp broadcastable to c[..., 0, 0],
    level_scale [..., 4, 4] already gathered for qp%6."""
    q6 = qp // 6
    hi = (c * level_scale) << jnp.maximum(q6 - 4, 0)[..., None, None]
    lo = (c * level_scale + (1 << jnp.maximum(3 - q6, 0))[..., None, None]) \
        >> jnp.maximum(4 - q6, 0)[..., None, None]
    return jnp.where((qp >= 24)[..., None, None], hi, lo)


def idct4x4_dev(d):
    """[..., 4, 4] int32 -> (h + 32) >> 6, spec 8.5.12.2 (matches oracle)."""
    def rows(m):  # combine along last axis
        e0 = m[..., 0] + m[..., 2]
        e1 = m[..., 0] - m[..., 2]
        e2 = (m[..., 1] >> 1) - m[..., 3]
        e3 = m[..., 1] + (m[..., 3] >> 1)
        return jnp.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)

    f = rows(d)
    h = jnp.swapaxes(rows(jnp.swapaxes(f, -1, -2)), -1, -2)
    return (h + 32) >> 6


def hadamard4_dev(c):
    """f = H @ c @ H with H rows of +-1 (spec 8.5.10), int exact."""
    def h(m):
        a, b, cc, d = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        return jnp.stack([a + b + cc + d, a + b - cc - d,
                          a - b - cc + d, a - b + cc - d], axis=-1)

    return jnp.swapaxes(h(jnp.swapaxes(h(c), -1, -2)), -1, -2)


def luma_dc_dequant_dev(c, qp, ls00_6):
    """Intra16x16 luma DC (spec 8.5.10). c [n,4,4], qp [n], ls00_6 [6] const."""
    f = hadamard4_dev(c)
    # 6-way select over the qp%6 classes
    m = qp % 6
    ls = jnp.broadcast_to(ls00_6[0], qp.shape)
    for k in range(1, 6):
        ls = jnp.where(m == k, ls00_6[k], ls)
    q6 = qp // 6
    hi = (f * ls[..., None, None]) << jnp.maximum(q6 - 6, 0)[..., None, None]
    lo = (f * ls[..., None, None] + (1 << jnp.maximum(5 - q6, 0))[..., None, None]) \
        >> jnp.maximum(6 - q6, 0)[..., None, None]
    return jnp.where((qp >= 36)[..., None, None], hi, lo)


def chroma_dc_dequant_dev(c, qpc, ls00):
    """2x2 chroma DC (spec 8.5.11). c [n,2,2], qpc [n], ls00 [n] gathered."""
    a, b = c[..., 0, 0], c[..., 0, 1]
    d, e = c[..., 1, 0], c[..., 1, 1]
    f = jnp.stack([jnp.stack([a + b + d + e, a - b + d - e], -1),
                   jnp.stack([a + b - d - e, a - b - d + e], -1)], -2)
    return ((f * ls00[..., None, None]) << (qpc // 6)[..., None, None]) >> 5


def dequant8x8_dev(c, qp, level_scale):
    """Spec 8.5.13.1. c [..., 8,8], level_scale [..., 8, 8] gathered."""
    q6 = qp // 6
    hi = (c * level_scale) << jnp.maximum(q6 - 6, 0)[..., None, None]
    lo = (c * level_scale + (1 << jnp.maximum(5 - q6, 0))[..., None, None]) \
        >> jnp.maximum(6 - q6, 0)[..., None, None]
    return jnp.where((qp >= 36)[..., None, None], hi, lo)


def idct8x8_dev(d):
    """[..., 8, 8] int32, spec 8.5.13.2."""
    def stage(m):
        d0, d1, d2, d3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        d4, d5, d6, d7 = m[..., 4], m[..., 5], m[..., 6], m[..., 7]
        e0 = d0 + d4
        e1 = -d3 + d5 - d7 - (d7 >> 1)
        e2 = d0 - d4
        e3 = d1 + d7 - d3 - (d3 >> 1)
        e4 = (d2 >> 1) - d6
        e5 = -d1 + d7 + d5 + (d5 >> 1)
        e6 = d2 + (d6 >> 1)
        e7 = d3 + d5 + d1 + (d1 >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return jnp.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                          f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)

    f = stage(d)                                              # horizontal
    k = jnp.swapaxes(stage(jnp.swapaxes(f, -1, -2)), -1, -2)  # vertical
    return (k + 32) >> 6


def blocks4_to_plane(blocks, mb_w: int, mb_h: int):
    """[n, 16, 4, 4] (raster 4x4 blocks) -> [16*mb_h, 16*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 4, 4, 4, 4)     # my,mx,y4,x4,py,px
    return b.transpose(0, 2, 4, 1, 3, 5).reshape(mb_h * 16, mb_w * 16)


def blocks8_to_plane(blocks, mb_w: int, mb_h: int):
    """[n, 4, 8, 8] (raster 8x8 blocks) -> [16*mb_h, 16*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 2, 2, 8, 8)
    return b.transpose(0, 2, 4, 1, 3, 5).reshape(mb_h * 16, mb_w * 16)


def blocks_c_to_plane(blocks, mb_w: int, mb_h: int):
    """[n, 2, 2, 4, 4] chroma raster blocks -> [8*mb_h, 8*mb_w]."""
    b = blocks.reshape(mb_h, mb_w, 2, 2, 4, 4)
    return b.transpose(0, 2, 4, 1, 3, 5).reshape(mb_h * 8, mb_w * 8)


def _mb_mask_to_plane(mask, mb_w: int, mb_h: int, size: int):
    m = mask.reshape(mb_h, mb_w).astype(jnp.bool_)
    return jnp.repeat(jnp.repeat(m, size, axis=0), size, axis=1)


def _pcm_luma_blocks(pcm):
    """[n,384] -> [n,16,4,4] raster 4x4 blocks of the 16x16 luma samples."""
    y = pcm[:, :256].reshape(-1, 4, 4, 4, 4)  # n, y4, py, x4, px
    return y.transpose(0, 1, 3, 2, 4).reshape(-1, 16, 4, 4)


def _gather_ls(table6, qp):
    """table6 [6,k,k] const -> [n,k,k] selected by qp%6 ([n]).

    Implemented as a 6-term select chain over the qp%6 classes."""
    t = jnp.asarray(table6)
    m = (qp % 6)[:, None, None]
    out = jnp.broadcast_to(t[0], (qp.shape[0],) + t.shape[1:])
    for k in range(1, 6):
        out = jnp.where(m == k, t[k], out)
    return out


def _sel52(table, idx):
    """52-entry const table -> [n] via run-length-compressed select chain."""
    tl = [int(v) for v in np.asarray(table).tolist()]
    out = jnp.full(idx.shape, tl[0], jnp.int32)
    for k in range(1, 52):
        if tl[k] != tl[k - 1]:
            out = jnp.where(idx >= k, tl[k], out)
    return out


def _tile_cumsum(plane, t: int, axis: int):
    """Per-tile cumulative sum: tiles of height (axis=0) or width (axis=1)
    `t`; the FRExt lossless intra DPCM (spec 8.3.5) in closed form —
    vertical DPCM recon u(i,j) = p(-1,j) + sum_{k<=i} r(k,j) is the
    standard vertical prediction plus a columnwise residual cumsum."""
    H, W = plane.shape
    if axis == 0:
        return plane.reshape(H // t, t, W).cumsum(axis=1).reshape(H, W)
    return plane.reshape(H, W // t, t).cumsum(axis=2).reshape(H, W)


def residual_planes(abi, mb_w: int, mb_h: int, ws4, ws8, cqp_off=(0, 0),
                    bypass: bool = False):
    """Full-frame residual computation (all MBs batched, no dependencies).

    abi: dict of jnp arrays per ops.abi (leading dim nMB).
    ws4: [6, 6, 4, 4] LevelScale4x4 per list (iY,iCb,iCr,pY,pCb,pCr).
    ws8: [2, 6, 8, 8] LevelScale8x8 (intra Y, inter Y).
    bypass: SPS qpprime_y_zero_transform_bypass_flag — MBs with QP'==0
    skip scaling+transform entirely (spec 8.5.15: residual = the parsed
    levels, already inverse-scanned to raster in the ABI) and intra
    vertical/horizontal blocks add the DPCM cumsum (spec 8.3.5, see
    _tile_cumsum).  Static flag: non-lossless pipelines compile without
    any of this.
    Returns (res_y, res_cb, res_cr) int32 planes; intra MBs still need the
    prediction stage, inter/PCM residuals are final adds.
    """
    kind = abi["kind"]
    qp = abi["qp"]
    n = kind.shape[0]
    is_intra = kind <= KIND_IPCM
    byp_mb = (qp == 0) if bypass else None
    # All-zero coeff tensors arrive OMITTED from the dict (ops.wire
    # unpack): skip the corresponding dequant/IDCT path entirely — a
    # CAVLC Baseline frame never pays the 8x8 path, a skip-heavy B
    # frame pays no chroma IDCT, and nobody pays the 12.5 MB/frame PCM
    # plane select unless a PCM MB actually occurred.

    # ---- luma 4x4 path (+ I16 DC scatter)
    if "luma4" in abi or "luma_dc" in abi:
        if "luma4" in abi:
            ls_intra = _gather_ls(ws4[0], qp)        # [n,4,4]
            ls_inter = _gather_ls(ws4[3], qp)
            ls_y = jnp.where(is_intra[:, None, None], ls_intra, ls_inter)
            d4 = dequant4x4_dev(abi["luma4"], qp[:, None], ls_y[:, None])
            raw4 = abi["luma4"] if bypass else None
        else:
            d4 = jnp.zeros((n, 16, 4, 4), jnp.int32)
            raw4 = jnp.zeros((n, 16, 4, 4), jnp.int32) if bypass else None
        if "luma_dc" in abi:
            dc = luma_dc_dequant_dev(abi["luma_dc"], qp, ws4[0, :, 0, 0])
            is16 = (kind == KIND_I16)[:, None]
            d4 = d4.at[:, :, 0, 0].set(
                jnp.where(is16, dc.reshape(-1, 16), d4[:, :, 0, 0]))
            if bypass:
                raw4 = raw4.at[:, :, 0, 0].set(
                    jnp.where(is16, abi["luma_dc"].reshape(-1, 16),
                              raw4[:, :, 0, 0]))
        plane4 = blocks4_to_plane(idct4x4_dev(d4), mb_w, mb_h)
        if bypass:
            byp_y = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 16)
            plane4 = jnp.where(byp_y, blocks4_to_plane(raw4, mb_w, mb_h),
                               plane4)
    else:
        plane4 = jnp.zeros((mb_h * 16, mb_w * 16), jnp.int32)
    res_y = plane4

    # ---- luma 8x8 path
    if "luma8" in abi:
        ls8 = jnp.where(is_intra[:, None, None], _gather_ls(ws8[0], qp),
                        _gather_ls(ws8[1], qp))
        d8 = dequant8x8_dev(abi["luma8"], qp[:, None], ls8[:, None])
        plane8 = blocks8_to_plane(idct8x8_dev(d8), mb_w, mb_h)
        if bypass:
            byp_y = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 16)
            plane8 = jnp.where(byp_y,
                               blocks8_to_plane(abi["luma8"], mb_w, mb_h),
                               plane8)
        tr8_plane = _mb_mask_to_plane(abi["tr8"] > 0, mb_w, mb_h, 16)
        res_y = jnp.where(tr8_plane, plane8, plane4)

    # ---- lossless intra DPCM (spec 8.3.5): vertical/horizontal intra
    # blocks of bypass MBs get the per-tile residual cumsum; the intra
    # stage's standard vertical/horizontal prediction then reconstructs
    # u(i,j) = pred + cumsum exactly.
    if bypass:
        from ..ops.abi import (
            KIND_I4x4 as _KI4, KIND_I8x8 as _KI8, KIND_I16 as _KI16,
        )

        def blkmask4(cond):                  # [n,16] bool -> [H,W]
            b = cond.reshape(mb_h, mb_w, 4, 4)
            b = jnp.repeat(jnp.repeat(b, 4, axis=2), 4, axis=3)
            return b.transpose(0, 2, 1, 3).reshape(mb_h * 16, mb_w * 16)

        def blkmask8(cond):                  # [n,4] bool -> [H,W]
            b = cond.reshape(mb_h, mb_w, 2, 2)
            b = jnp.repeat(jnp.repeat(b, 8, axis=2), 8, axis=3)
            return b.transpose(0, 2, 1, 3).reshape(mb_h * 16, mb_w * 16)

        bb = byp_mb
        i4 = (kind == _KI4) & bb
        i8 = (kind == _KI8) & bb
        i16 = (kind == _KI16) & bb
        m = abi["i4_modes"]
        v4 = blkmask4((m == 0) & i4[:, None])
        h4 = blkmask4((m == 1) & i4[:, None])
        m8 = abi["i8_modes"]
        v8 = blkmask8((m8 == 0) & i8[:, None])
        h8 = blkmask8((m8 == 1) & i8[:, None])
        v16 = _mb_mask_to_plane((abi["i16_mode"] == 0) & i16, mb_w, mb_h, 16)
        h16 = _mb_mask_to_plane((abi["i16_mode"] == 1) & i16, mb_w, mb_h, 16)
        res_y = jnp.where(v4, _tile_cumsum(res_y, 4, 0), res_y)
        res_y = jnp.where(h4, _tile_cumsum(res_y, 4, 1), res_y)
        res_y = jnp.where(v8, _tile_cumsum(res_y, 8, 0), res_y)
        res_y = jnp.where(h8, _tile_cumsum(res_y, 8, 1), res_y)
        res_y = jnp.where(v16, _tile_cumsum(res_y, 16, 0), res_y)
        res_y = jnp.where(h16, _tile_cumsum(res_y, 16, 1), res_y)

    # ---- PCM luma (residual = raw samples; prediction stage emits 0)
    if "pcm" in abi:
        pcm_plane = blocks4_to_plane(_pcm_luma_blocks(abi["pcm"]),
                                     mb_w, mb_h)
        is_pcm_plane = _mb_mask_to_plane(kind == KIND_IPCM, mb_w, mb_h, 16)
        res_y = jnp.where(is_pcm_plane, pcm_plane, res_y)

    # ---- chroma
    res_c = []
    for pl in range(2):
        if "chroma_ac" in abi or "chroma_dc" in abi:
            qpc = _sel52(_CQP, jnp.clip(qp + cqp_off[pl], 0, 51))

            def sel6(tab6, m):
                o = jnp.broadcast_to(tab6[0], m.shape)
                for k in range(1, 6):
                    o = jnp.where(m == k, tab6[k], o)
                return o

            if "chroma_ac" in abi:
                ls_c = jnp.where(is_intra[:, None, None],
                                 _gather_ls(ws4[1 + pl], qpc),
                                 _gather_ls(ws4[4 + pl], qpc))
                ac = abi["chroma_ac"][:, pl].reshape(-1, 4, 4, 4)
                dca = dequant4x4_dev(ac, qpc[:, None], ls_c[:, None])
            else:
                dca = jnp.zeros((n, 4, 4, 4), jnp.int32)
            if "chroma_dc" in abi:
                ls00 = jnp.where(is_intra,
                                 sel6(ws4[1 + pl, :, 0, 0], qpc % 6),
                                 sel6(ws4[4 + pl, :, 0, 0], qpc % 6))
                dcc = chroma_dc_dequant_dev(abi["chroma_dc"][:, pl], qpc,
                                            ls00)
                dca = dca.at[:, :, 0, 0].set(dcc.reshape(-1, 4))
            rc = idct4x4_dev(dca).reshape(-1, 2, 2, 4, 4)
            plane_c = blocks_c_to_plane(rc, mb_w, mb_h)
            if bypass:
                # raw levels (2x2 DC Hadamard bypassed too, spec 8.5.15)
                if "chroma_ac" in abi:
                    rawc = abi["chroma_ac"][:, pl].reshape(-1, 4, 4, 4)
                else:
                    rawc = jnp.zeros((n, 4, 4, 4), jnp.int32)
                if "chroma_dc" in abi:
                    rawc = rawc.at[:, :, 0, 0].set(
                        abi["chroma_dc"][:, pl].reshape(-1, 4))
                raw_plane = blocks_c_to_plane(
                    rawc.reshape(-1, 2, 2, 4, 4), mb_w, mb_h)
                byp_c = _mb_mask_to_plane(byp_mb, mb_w, mb_h, 8)
                plane_c = jnp.where(byp_c, raw_plane, plane_c)
                # chroma intra DPCM: mode 1 = horizontal, 2 = vertical,
                # over the whole 8x8 chroma MB (chroma pred is per-MB)
                cm = abi["chroma_mode"]
                vm = _mb_mask_to_plane((cm == 2) & is_intra & byp_mb
                                       & (kind != KIND_IPCM), mb_w, mb_h, 8)
                hm = _mb_mask_to_plane((cm == 1) & is_intra & byp_mb
                                       & (kind != KIND_IPCM), mb_w, mb_h, 8)
                plane_c = jnp.where(vm, _tile_cumsum(plane_c, 8, 0),
                                    plane_c)
                plane_c = jnp.where(hm, _tile_cumsum(plane_c, 8, 1),
                                    plane_c)
        else:
            plane_c = jnp.zeros((mb_h * 8, mb_w * 8), jnp.int32)
        if "pcm" in abi:
            pcm_c = blocks_c_to_plane(
                abi["pcm"][:, 256 + 64 * pl:256 + 64 * (pl + 1)]
                .reshape(-1, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4),
                mb_w, mb_h)
            is_pcm_c = _mb_mask_to_plane(kind == KIND_IPCM, mb_w, mb_h, 8)
            plane_c = jnp.where(is_pcm_c, pcm_c, plane_c)
        res_c.append(plane_c)
    return res_y, res_c[0], res_c[1]


def make_ws_consts(scaling_4x4, scaling_8x8):
    """Host helper: scaling lists (zig-zag order) -> LevelScale device consts.

    Returns (ws4 [6,6,4,4], ws8 [2,6,8,8]) numpy int32:
    LevelScale(m,i,j) = weightScale(i,j) * normAdjust(m,i,j)  (spec 8.5.9).
    """
    from ..oracle.transforms import weight_scale_raster_4x4, weight_scale_raster_8x8
    ws4 = np.zeros((6, 6, 4, 4), np.int32)
    for i in range(6):
        ws4[i] = weight_scale_raster_4x4(scaling_4x4[i])[None] * NORM_ADJUST_4x4
    ws8 = np.zeros((2, 6, 8, 8), np.int32)
    for i in range(min(2, len(scaling_8x8))):
        ws8[i] = weight_scale_raster_8x8(scaling_8x8[i])[None] * NORM_ADJUST_8x8
    return ws4, ws8
