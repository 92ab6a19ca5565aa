"""Device in-loop deblocking: wavefront-phased batched-MB kernels (JAX).

Reference parity: JM-lineage `loopFilter.c` (SURVEY.md §3.5) with the spec's
MB-serial semantics preserved by the knight-move wavefront (phase = 2*mb_y +
mb_x): an MB's filtering depends on left/top/top-right MBs, all in earlier
phases.  Within an MB the 4 vertical then 4 horizontal edges are sequential
static steps; across MBs of a phase everything is vectorized.

Bit-exact vs oracle.deblock (same integer formulas, same order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..common.tables import ALPHA_TABLE, BETA_TABLE, CHROMA_QP_TABLE, TC0_TABLE
from .intra import build_schedule

_ALPHA = np.asarray(ALPHA_TABLE, np.int32)
_BETA = np.asarray(BETA_TABLE, np.int32)
_TC0 = np.asarray(TC0_TABLE, np.int32)          # [3, 52]
_CQP = np.asarray(CHROMA_QP_TABLE, np.int32)


def _mv_far(a, b):
    """a, b [..., 2] qpel MVs -> bool."""
    return (jnp.abs(a[..., 0] - b[..., 0]) >= 4) | \
           (jnp.abs(a[..., 1] - b[..., 1]) >= 4)


def _bs_pair(ip, iq, mb_edge, nzp, nzq, refp, refq, mvp, mvq, bs4=4):
    """Boundary strength (spec 8.7.2.1), vectorized over [...].

    refp/refq [..., 2] picture ids (-1 unused); mvp/mvq [..., 2, 2].
    bs4: strength of intra MACROBLOCK edges — 4, except HORIZONTAL MB
    edges of FIELD pictures take 3 (8.7.2.1: bS 4 needs verticalEdgeFlag
    or a frame picture).
    """
    n_p = (refp >= 0).sum(-1)
    n_q = (refq >= 0).sum(-1)
    sets_eq = (jnp.minimum(refp[..., 0], refp[..., 1]) ==
               jnp.minimum(refq[..., 0], refq[..., 1])) & \
              (jnp.maximum(refp[..., 0], refp[..., 1]) ==
               jnp.maximum(refq[..., 0], refq[..., 1]))
    # single-MV: pick the used list
    p_use0 = (refp[..., 0] >= 0)[..., None]
    q_use0 = (refq[..., 0] >= 0)[..., None]
    mv1p = jnp.where(p_use0, mvp[..., 0, :], mvp[..., 1, :])
    mv1q = jnp.where(q_use0, mvq[..., 0, :], mvq[..., 1, :])
    far1 = _mv_far(mv1p, mv1q)
    # two-MV: two pairings
    straight = _mv_far(mvp[..., 0, :], mvq[..., 0, :]) | \
        _mv_far(mvp[..., 1, :], mvq[..., 1, :])
    crossed = _mv_far(mvp[..., 0, :], mvq[..., 1, :]) | \
        _mv_far(mvp[..., 1, :], mvq[..., 0, :])
    same_ref_pair = refp[..., 0] == refp[..., 1]
    # distinct refs: match q order to p by picture id
    q_matches = refq[..., 0] == refp[..., 0]
    far2_distinct = jnp.where(q_matches, straight, crossed)
    far2_same = straight & crossed
    far2 = jnp.where(same_ref_pair, far2_same, far2_distinct)
    far = jnp.where(n_p == 1, far1, jnp.where(n_p == 2, far2, False))
    mv_bs = jnp.where((n_p != n_q) | ~sets_eq | far, 1, 0)
    bs = jnp.where(nzp | nzq, 2, mv_bs)
    bs = jnp.where(ip | iq, jnp.where(mb_edge, bs4, 3), bs)
    return bs


def _filter_luma(p, q, bs, index_a, alpha, beta):
    """p [..., 4] = (p3,p2,p1,p0), q [..., 4] = (q0..q3); bs/idx broadcast.

    Returns filtered (p, q).  spec 8.7.2.3 / 8.7.2.4.
    """
    p3, p2, p1, p0 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    filt = (bs > 0) & (jnp.abs(p0 - q0) < alpha) & \
        (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta)
    ap = jnp.abs(p2 - p0) < beta
    aq = jnp.abs(q2 - q0) < beta
    # --- bS < 4 path
    tc0 = jnp.asarray(_TC0)[jnp.clip(bs - 1, 0, 2), index_a]
    tc = tc0 + ap.astype(jnp.int32) + aq.astype(jnp.int32)
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_w = jnp.clip(p0 + delta, 0, 255)
    nq0_w = jnp.clip(q0 - delta, 0, 255)
    np1_w = p1 + jnp.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0)
    nq1_w = q1 + jnp.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0)
    np1_w = jnp.where(ap, np1_w, p1)
    nq1_w = jnp.where(aq, nq1_w, q1)
    # --- bS == 4 path
    strong = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp_ = strong & ap
    np0_s = jnp.where(sp_, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    np1_s = jnp.where(sp_, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    np2_s = jnp.where(sp_, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq_ = strong & aq
    nq0_s = jnp.where(sq_, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    nq1_s = jnp.where(sq_, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    nq2_s = jnp.where(sq_, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    is4 = bs == 4
    np0 = jnp.where(is4, np0_s, np0_w)
    np1 = jnp.where(is4, np1_s, np1_w)
    np2 = jnp.where(is4, np2_s, p2)
    nq0 = jnp.where(is4, nq0_s, nq0_w)
    nq1 = jnp.where(is4, nq1_s, nq1_w)
    nq2 = jnp.where(is4, nq2_s, q2)
    np0 = jnp.where(filt, np0, p0)
    np1 = jnp.where(filt, np1, p1)
    np2 = jnp.where(filt, np2, p2)
    nq0 = jnp.where(filt, nq0, q0)
    nq1 = jnp.where(filt, nq1, q1)
    nq2 = jnp.where(filt, nq2, q2)
    return (jnp.stack([p3, np2, np1, np0], -1),
            jnp.stack([nq0, nq1, nq2, q3], -1))


def _filter_chroma(p, q, bs, index_a, alpha, beta):
    """p [..., 2] = (p1, p0), q [..., 2] = (q0, q1)."""
    p1, p0 = p[..., 0], p[..., 1]
    q0, q1 = q[..., 0], q[..., 1]
    filt = (bs > 0) & (jnp.abs(p0 - q0) < alpha) & \
        (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta)
    tc = jnp.asarray(_TC0)[jnp.clip(bs - 1, 0, 2), index_a] + 1
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_w = jnp.clip(p0 + delta, 0, 255)
    nq0_w = jnp.clip(q0 - delta, 0, 255)
    np0_s = (2 * p1 + p0 + q1 + 2) >> 2
    nq0_s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    np0 = jnp.where(filt, jnp.where(is4, np0_s, np0_w), p0)
    nq0 = jnp.where(filt, jnp.where(is4, nq0_s, nq0_w), q0)
    return (jnp.stack([p1, np0], -1), jnp.stack([nq0, q1], -1))


def _idx_ab(qp_p, qp_q, a_off, b_off):
    qpav = (qp_p + qp_q + 1) >> 1
    ia = jnp.clip(qpav + a_off, 0, 51)
    ib = jnp.clip(qpav + b_off, 0, 51)
    return ia, ib


def deblock_planes(abi, y, cb, cr, mb_w: int, mb_h: int, cqp_off=(0, 0),
                   field: bool = False):
    """Apply the full deblocking process.  y [H, W] int32 etc.  Returns planes.

    Planes are padded bottom/right; masked-off jobs gather AND scatter in the
    pad corner so duplicate scatter targets always carry identical values
    (deterministic no-ops) and never collide with active MBs.
    """
    H, W = mb_h * 16, mb_w * 16
    y = jnp.pad(y, ((0, 16), (0, 16)))
    cb = jnp.pad(cb, ((0, 8), (0, 8)))
    cr = jnp.pad(cr, ((0, 8), (0, 8)))
    n = mb_w * mb_h
    kind = abi["kind"]
    is_intra_all = kind <= 3
    nz_all = abi["nz"] > 0                       # [n,4,4]
    mv_all = abi["mv"]                           # [n,4,4,2,2]
    ref_all = abi["refid"]                       # [n,4,4,2]
    qp_all = abi["qp"]
    sid_all = abi["slice_id"]
    dis_all = abi["disable_idc"]
    aoff_all = abi["alpha_off"]
    boff_all = abi["beta_off"]
    tr8_all = abi["tr8"] > 0
    mb_idx, active = build_schedule(mb_w, mb_h)

    def neigh(arr, idx, d):
        """arr indexed at idx+d with clamp (validity handled by masks)."""
        return jnp.take(arr, jnp.clip(idx + d, 0, n - 1), axis=0)

    def phase_body(carry, xs):
        y, cb, cr = carry
        idx, act = xs
        mbx = idx % mb_w
        mby = idx // mb_w
        cur_i = jnp.take(is_intra_all, idx)
        cur_nz = jnp.take(nz_all, idx, axis=0)
        cur_mv = jnp.take(mv_all, idx, axis=0)
        cur_ref = jnp.take(ref_all, idx, axis=0)
        cur_qp = jnp.take(qp_all, idx)
        cur_sid = jnp.take(sid_all, idx)
        cur_dis = jnp.take(dis_all, idx)
        a_off = jnp.take(aoff_all, idx)
        b_off = jnp.take(boff_all, idx)
        cur_tr8 = jnp.take(tr8_all, idx)
        do_any = act & (cur_dis != 1)

        left_ok = (mbx > 0) & do_any & ~(
            (cur_dis == 2) & (neigh(sid_all, idx, -1) != cur_sid))
        top_ok = (mby > 0) & do_any & ~(
            (cur_dis == 2) & (neigh(sid_all, idx, -mb_w) != cur_sid))

        def edge_v(y, cb, cr, xe: int):
            mb_edge = xe == 0
            mask = left_ok if mb_edge else (
                do_any & (~cur_tr8 if xe in (4, 12) else True))
            pid = idx - 1 if mb_edge else idx
            p_i = jnp.take(is_intra_all, jnp.clip(pid, 0, n - 1))
            p_nz = jnp.take(nz_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_mv = jnp.take(mv_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_ref = jnp.take(ref_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_qp = jnp.take(qp_all, jnp.clip(pid, 0, n - 1))
            bxp = 3 if mb_edge else xe // 4 - 1
            bxq = xe // 4
            segs = jnp.arange(4)
            bs = _bs_pair(p_i[:, None], cur_i[:, None], mb_edge,
                          p_nz[:, :, bxp], cur_nz[:, :, bxq],
                          p_ref[:, :, bxp], cur_ref[:, :, bxq],
                          p_mv[:, :, bxp], cur_mv[:, :, bxq])  # [P, 4]
            ia, ib = _idx_ab(p_qp, cur_qp, a_off, b_off)   # [P] (per MB pair)
            alpha = jnp.asarray(_ALPHA)[ia]
            beta = jnp.asarray(_BETA)[ib]
            # luma: window [P, 16, 8] at (my*16, mx*16+xe-4); masked -> pad
            py0 = jnp.where(mask, mby * 16, H)
            px0 = jnp.where(mask, mbx * 16 + xe - 4, W)
            win = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
                y, (yy, xx), (16, 8)))(py0, px0)
            rep = lambda a: jnp.repeat(a, 4, axis=1)   # [P,4] -> [P,16]
            fp, fq = _filter_luma(win[:, :, 0:4], win[:, :, 4:8], rep(bs),
                                  ia[:, None], alpha[:, None], beta[:, None])
            out = jnp.concatenate([fp, fq], axis=-1)
            out = jnp.where(mask[:, None, None], out, win)
            ys = py0[:, None, None] + jnp.arange(16)[None, :, None]
            xs_ = px0[:, None, None] + jnp.arange(8)[None, None, :]
            y = y.at[ys, xs_].set(out)
            # chroma for luma edges 0 and 8
            if xe % 8 == 0:
                for pl, plane, off in ((0, cb, cqp_off[0]), (1, cr, cqp_off[1])):
                    qpc_p = jnp.asarray(_CQP)[jnp.clip(p_qp + off, 0, 51)]
                    qpc_q = jnp.asarray(_CQP)[jnp.clip(cur_qp + off, 0, 51)]
                    iac, ibc = _idx_ab(qpc_p, qpc_q, a_off, b_off)
                    al_c = jnp.asarray(_ALPHA)[iac]
                    be_c = jnp.asarray(_BETA)[ibc]
                    pyc0 = jnp.where(mask, mby * 8, H // 2)
                    pxc0 = jnp.where(mask, mbx * 8 + xe // 2 - 2, W // 2)
                    winc = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
                        plane, (yy, xx), (8, 4)))(pyc0, pxc0)
                    repc = lambda a: jnp.repeat(a, 2, axis=1)  # per 2 rows
                    fpc, fqc = _filter_chroma(
                        winc[:, :, 0:2], winc[:, :, 2:4], repc(bs),
                        iac[:, None], al_c[:, None], be_c[:, None])
                    outc = jnp.concatenate([fpc, fqc], axis=-1)
                    outc = jnp.where(mask[:, None, None], outc, winc)
                    ysc = pyc0[:, None, None] + jnp.arange(8)[None, :, None]
                    xsc = pxc0[:, None, None] + jnp.arange(4)[None, None, :]
                    if pl == 0:
                        cb = cb.at[ysc, xsc].set(outc)
                    else:
                        cr = cr.at[ysc, xsc].set(outc)
            return y, cb, cr

        def edge_h(y, cb, cr, ye: int):
            mb_edge = ye == 0
            mask = top_ok if mb_edge else (
                do_any & (~cur_tr8 if ye in (4, 12) else True))
            pid = idx - mb_w if mb_edge else idx
            p_i = jnp.take(is_intra_all, jnp.clip(pid, 0, n - 1))
            p_nz = jnp.take(nz_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_mv = jnp.take(mv_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_ref = jnp.take(ref_all, jnp.clip(pid, 0, n - 1), axis=0)
            p_qp = jnp.take(qp_all, jnp.clip(pid, 0, n - 1))
            byp = 3 if mb_edge else ye // 4 - 1
            byq = ye // 4
            bs = _bs_pair(p_i[:, None], cur_i[:, None], mb_edge,
                          p_nz[:, byp, :], cur_nz[:, byq, :],
                          p_ref[:, byp, :], cur_ref[:, byq, :],
                          p_mv[:, byp, :], cur_mv[:, byq, :],
                          bs4=3 if field else 4)  # [P, 4]
            ia, ib = _idx_ab(p_qp, cur_qp, a_off, b_off)
            alpha = jnp.asarray(_ALPHA)[ia]
            beta = jnp.asarray(_BETA)[ib]
            py0 = jnp.where(mask, mby * 16 + ye - 4, H)
            px0 = jnp.where(mask, mbx * 16, W)
            win = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
                y, (yy, xx), (8, 16)))(py0, px0)
            winT = jnp.swapaxes(win, 1, 2)               # [P, 16, 8]
            rep = lambda a: jnp.repeat(a, 4, axis=1)
            fp, fq = _filter_luma(winT[:, :, 0:4], winT[:, :, 4:8], rep(bs),
                                  ia[:, None], alpha[:, None], beta[:, None])
            outT = jnp.concatenate([fp, fq], axis=-1)
            out = jnp.swapaxes(outT, 1, 2)
            out = jnp.where(mask[:, None, None], out, win)
            ys = py0[:, None, None] + jnp.arange(8)[None, :, None]
            xs_ = px0[:, None, None] + jnp.arange(16)[None, None, :]
            y = y.at[ys, xs_].set(out)
            if ye % 8 == 0:
                for pl, plane, off in ((0, cb, cqp_off[0]), (1, cr, cqp_off[1])):
                    qpc_p = jnp.asarray(_CQP)[jnp.clip(p_qp + off, 0, 51)]
                    qpc_q = jnp.asarray(_CQP)[jnp.clip(cur_qp + off, 0, 51)]
                    iac, ibc = _idx_ab(qpc_p, qpc_q, a_off, b_off)
                    al_c = jnp.asarray(_ALPHA)[iac]
                    be_c = jnp.asarray(_BETA)[ibc]
                    pyc0 = jnp.where(mask, mby * 8 + ye // 2 - 2, H // 2)
                    pxc0 = jnp.where(mask, mbx * 8, W // 2)
                    winc = jax.vmap(lambda yy, xx: jax.lax.dynamic_slice(
                        plane, (yy, xx), (4, 8)))(pyc0, pxc0)
                    wincT = jnp.swapaxes(winc, 1, 2)
                    repc = lambda a: jnp.repeat(a, 2, axis=1)
                    fpc, fqc = _filter_chroma(
                        wincT[:, :, 0:2], wincT[:, :, 2:4], repc(bs),
                        iac[:, None], al_c[:, None], be_c[:, None])
                    outc = jnp.swapaxes(jnp.concatenate([fpc, fqc], -1), 1, 2)
                    outc = jnp.where(mask[:, None, None], outc, winc)
                    ysc = pyc0[:, None, None] + jnp.arange(4)[None, :, None]
                    xsc = pxc0[:, None, None] + jnp.arange(8)[None, None, :]
                    if pl == 0:
                        cb = cb.at[ysc, xsc].set(outc)
                    else:
                        cr = cr.at[ysc, xsc].set(outc)
            return y, cb, cr

        for xe in (0, 4, 8, 12):
            y, cb, cr = edge_v(y, cb, cr, xe)
        for ye in (0, 4, 8, 12):
            y, cb, cr = edge_h(y, cb, cr, ye)
        return (y, cb, cr), None

    (y, cb, cr), _ = jax.lax.scan(phase_body, (y, cb, cr), (mb_idx, active))
    return y[:H, :W], cb[:H // 2, :W // 2], cr[:H // 2, :W // 2]
