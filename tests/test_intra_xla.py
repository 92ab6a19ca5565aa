"""The knight-phase intra wavefront (ops.intra.intra_reconstruct) vs a
serial numpy reconstruction built on the spec-literal oracle
(oracle.intra).

Fully randomized ABIs (all kinds incl. I8x8/PCM/inter passthrough, random
modes and avails) across geometries with distinct phase counts and widths.
Random avail flags can mark a neighbour "available" that the spec would
not, so the serial reference visits MBs in raster order and the blocks of
an MB in the wavefront's sub-step order (2*y + x), which reads every
neighbour in the same state the wavefront does.

PCM residuals are generated in [0,255]: the ABI contract is that `res`
carries the raw PCM samples for IPCM MBs (spec 8.3.5, no clip).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from arrow_h264_tpu.ops.intra import intra_reconstruct
from arrow_h264_tpu.oracle.intra import (
    chroma_pred, filter_intra8x8_refs, intra16x16_pred, intra_nxn_pred,
)

# luma 4x4 blocks (raster r = 4*y4 + x4) in wavefront sub-step order
_BLK4_ORDER = sorted(range(16), key=lambda r: 2 * (r // 4) + r % 4)


def rand_abi(mb_w, mb_h, seed):
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    return dict(
        kind=rng.choice([0, 1, 2, 3, 4], n,
                        p=[.3, .25, .2, .05, .2]).astype(np.int32),
        i4_modes=rng.integers(0, 9, (n, 16)).astype(np.int32),
        i4_avail=rng.integers(0, 2, (n, 16, 4)).astype(np.int32),
        i8_modes=rng.integers(0, 9, (n, 4)).astype(np.int32),
        i8_avail=rng.integers(0, 2, (n, 4, 4)).astype(np.int32),
        i16_mode=rng.integers(0, 4, n).astype(np.int32),
        chroma_mode=rng.integers(0, 4, n).astype(np.int32),
        mb_avail=rng.integers(0, 2, (n, 3)).astype(np.int32),
    )


def _neighbours(buf, py, px, n_top, n_left, al, at, atl):
    """(topleft, top [n_top], left [n_left]) from a plane with a zero
    border; unavailable samples read as 0."""
    H, W = buf.shape
    pad = np.zeros((H + 1, W + 16), np.int64)
    pad[1:, 1:W + 1] = buf
    tl = int(pad[py, px]) if atl else 0
    top = pad[py, px + 1:px + 1 + n_top].copy() if at \
        else np.zeros(n_top, np.int64)
    left = pad[py + 1:py + 1 + n_left, px].copy() if al \
        else np.zeros(n_left, np.int64)
    return tl, top, left


def serial_reconstruct(a, res_y, res_cb, res_cr, init_y, init_cb, init_cr,
                       mb_w, mb_h):
    y = init_y.astype(np.int64).copy()
    cb = init_cb.astype(np.int64).copy()
    cr = init_cr.astype(np.int64).copy()
    for mb in range(mb_w * mb_h):
        kind = a["kind"][mb]
        if kind == 4:
            continue                            # inter: init passes through
        mx, my = mb % mb_w, mb // mb_w
        X, Y = mx * 16, my * 16
        al, at, atl = (bool(v) for v in a["mb_avail"][mb])
        if kind == 2:
            tl, top, left = _neighbours(y, Y, X, 16, 16, al, at, atl)
            pred = intra16x16_pred(a["i16_mode"][mb], top, left, tl, at, al)
            y[Y:Y + 16, X:X + 16] = np.clip(pred + res_y[Y:Y + 16, X:X + 16],
                                            0, 255)
        elif kind == 3:
            y[Y:Y + 16, X:X + 16] = res_y[Y:Y + 16, X:X + 16]
        for plane, res in ((cb, res_cb), (cr, res_cr)):
            tl, top, left = _neighbours(plane, Y // 2, X // 2, 8, 8,
                                        al, at, atl)
            pred = 0 if kind == 3 else chroma_pred(
                a["chroma_mode"][mb], top, left, tl, at, al)
            sl = (slice(Y // 2, Y // 2 + 8), slice(X // 2, X // 2 + 8))
            plane[sl] = np.clip(pred + res[sl], 0, 255)
        if kind == 0:
            for r in _BLK4_ORDER:
                by, bx = Y + (r // 4) * 4, X + (r % 4) * 4
                bl, bt, btl, btr = (bool(v) for v in a["i4_avail"][mb, r])
                tl, top, left = _neighbours(y, by, bx, 8, 4, bl, bt, btl)
                if bt and not btr:
                    top[4:] = top[3]
                pred = intra_nxn_pred(a["i4_modes"][mb, r], 4, top, left, tl,
                                      bt, bl, btl)
                y[by:by + 4, bx:bx + 4] = np.clip(
                    pred + res_y[by:by + 4, bx:bx + 4], 0, 255)
        elif kind == 1:
            for b8 in range(4):
                by, bx = Y + (b8 // 2) * 8, X + (b8 % 2) * 8
                bl, bt, btl, btr = (bool(v) for v in a["i8_avail"][mb, b8])
                tl, top, left = _neighbours(y, by, bx, 16, 8, bl, bt, btl)
                if bt and not btr:
                    top[8:] = top[7]
                ft, fl, ftl = filter_intra8x8_refs(top, left, tl, bt, bl, btl)
                pred = intra_nxn_pred(a["i8_modes"][mb, b8], 8, ft, fl, ftl,
                                      bt, bl, btl)
                y[by:by + 8, bx:bx + 8] = np.clip(
                    pred + res_y[by:by + 8, bx:bx + 8], 0, 255)
    return y, cb, cr


@pytest.mark.parametrize("mb_w,mb_h", [(5, 4), (3, 7), (9, 2)])
def test_intra_phase_equivalence(mb_w, mb_h):
    H, W = mb_h * 16, mb_w * 16
    rng = np.random.default_rng(99)
    a = rand_abi(mb_w, mb_h, 10 * mb_w)
    res_y = rng.integers(-300, 300, (H, W)).astype(np.int32)
    res_cb = rng.integers(-100, 100, (H // 2, W // 2)).astype(np.int32)
    res_cr = rng.integers(-100, 100, (H // 2, W // 2)).astype(np.int32)
    pcm = a["kind"].reshape(mb_h, mb_w) == 3
    for yy, xx in zip(*np.nonzero(pcm)):
        res_y[yy * 16:yy * 16 + 16, xx * 16:xx * 16 + 16] %= 256
        res_cb[yy * 8:yy * 8 + 8, xx * 8:xx * 8 + 8] %= 256
        res_cr[yy * 8:yy * 8 + 8, xx * 8:xx * 8 + 8] %= 256
    init_y = rng.integers(0, 256, (H, W)).astype(np.int32)
    init_cb = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)
    init_cr = rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32)

    got = intra_reconstruct({k: jnp.asarray(v) for k, v in a.items()},
                            jnp.asarray(res_y), jnp.asarray(res_cb),
                            jnp.asarray(res_cr), mb_w, mb_h,
                            jnp.asarray(init_y), jnp.asarray(init_cb),
                            jnp.asarray(init_cr))
    want = serial_reconstruct(a, res_y, res_cb, res_cr, init_y, init_cb,
                              init_cr, mb_w, mb_h)
    for pi, (g, e) in enumerate(zip(got, want)):
        # chroma comes back with the wavefront's scratch rows below it
        np.testing.assert_array_equal(np.asarray(g)[:e.shape[0]], e,
                                      err_msg=f"plane {pi}")
