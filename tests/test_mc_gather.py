"""Gather MC straight off the packed device DPB vs the spec-literal numpy
oracle (oracle.inter): quarter-pel luma, 1/8-pel chroma, explicit
weights, wild MVs far outside the picture, and the stream-batched vmap."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from arrow_h264_tpu.models.pipeline import dpb_alloc, store_ref_fn
from arrow_h264_tpu.ops.inter import inter_predict_packed
from arrow_h264_tpu.oracle.inter import (
    chroma_block_mc, luma_block_mc, weight_bi, weight_uni,
)

MB_W, MB_H = 6, 4
H, W = MB_H * 16, MB_W * 16
S = 3


def make_dpb(rng, planes=None):
    """Random reference frames -> (raw (y, cb, cr) per slot, packed DPB)."""
    raw = planes or [
        (rng.integers(0, 256, (H, W), np.uint8),
         rng.integers(0, 256, (H // 2, W // 2), np.uint8),
         rng.integers(0, 256, (H // 2, W // 2), np.uint8))
        for _ in range(S)]
    dpb = dpb_alloc(MB_W, MB_H, S)
    for s, (y, cb, cr) in enumerate(raw):
        dpb = store_ref_fn(*dpb, s, jnp.asarray(y), jnp.asarray(cb),
                           jnp.asarray(cr))
    return raw, dpb


def make_abi(rng, *, lists, weighted=False, mv_lo=-40, mv_hi=40):
    n = MB_W * MB_H
    palette = rng.integers(mv_lo, mv_hi, (12, 2)).astype(np.int32)
    mv = palette[rng.integers(0, len(palette), (n, 4, 4, 2))]
    refslot = np.full((n, 4, 4, 2), -1, np.int32)
    for l in lists:
        refslot[..., l] = rng.integers(0, S, (n, 4, 4))
    if len(lists) == 2:
        # some blocks single-list
        drop = rng.random((n, 4, 4)) < 0.3
        which = rng.integers(0, 2, (n, 4, 4))
        for l in (0, 1):
            refslot[..., l][drop & (which == l)] = -1
    wp = np.zeros((n, 4, 4, 2, 3, 2), np.int32)
    logwd = np.zeros((n, 2), np.int32)
    if weighted:
        logwd[:] = [5, 6]
        wp[..., 0] = rng.integers(20, 44, (n, 4, 4, 2, 3))
        wp[..., 1] = rng.integers(-20, 20, (n, 4, 4, 2, 3))
    else:
        wp[..., 0] = 1
    kind = np.full(n, 4, np.int32)
    return {"mv": mv, "refslot": refslot, "wp": wp, "logwd": logwd,
            "kind": kind}


def oracle_predict(abi, raw):
    """Per-cell spec MC + weighting -> (y [H,W], cb, cr) int32 and the
    mask of cells that use any list."""
    y = np.zeros((H, W), np.int32)
    cb = np.zeros((H // 2, W // 2), np.int32)
    cr = np.zeros((H // 2, W // 2), np.int32)
    used_any = np.zeros((H, W), bool)
    for mb in range(MB_W * MB_H):
        mx, my = mb % MB_W, mb // MB_W
        for cy4 in range(4):
            for cx4 in range(4):
                rs = abi["refslot"][mb, cy4, cx4]
                if (rs < 0).all():
                    continue
                bx, by = mx * 16 + cx4 * 4, my * 16 + cy4 * 4
                cx, cy = bx // 2, by // 2
                preds = []
                for l in (0, 1):
                    if rs[l] < 0:
                        preds.append(None)
                        continue
                    ry, rcb, rcr = raw[rs[l]]
                    mvx, mvy = (int(v) for v in abi["mv"][mb, cy4, cx4, l])
                    preds.append((luma_block_mc(ry, bx, by, mvx, mvy, 4, 4),
                                  chroma_block_mc(rcb, cx, cy, mvx, mvy, 2, 2),
                                  chroma_block_mc(rcr, cx, cy, mvx, mvy, 2, 2)))
                wp = abi["wp"][mb, cy4, cx4]          # [list, plane, (w, o)]
                outs = []
                for p in range(3):
                    lw = int(abi["logwd"][mb, 0 if p == 0 else 1])
                    if preds[0] is not None and preds[1] is not None:
                        outs.append(weight_bi(
                            preds[0][p], preds[1][p], wp[0, p, 0], wp[1, p, 0],
                            wp[0, p, 1], wp[1, p, 1], lw))
                    else:
                        l = 0 if preds[0] is not None else 1
                        outs.append(weight_uni(preds[l][p], wp[l, p, 0],
                                               wp[l, p, 1], lw))
                y[by:by + 4, bx:bx + 4] = outs[0]
                cb[cy:cy + 2, cx:cx + 2] = outs[1]
                cr[cy:cy + 2, cx:cx + 2] = outs[2]
                used_any[by:by + 4, bx:bx + 4] = True
    return (y, cb, cr), used_any


def assert_matches_oracle(abi_np, raw, dpb):
    abi = {k: jnp.asarray(v) for k, v in abi_np.items()}
    got = inter_predict_packed(abi, *dpb, MB_W, MB_H)
    want, used = oracle_predict(abi_np, raw)
    masks = (used, used[::2, ::2], used[::2, ::2])
    for g, w, m, name in zip(got, want, masks, ("y", "cb", "cr")):
        bad = (np.asarray(g) != w) & m
        assert not bad.any(), (name, np.argwhere(bad)[:4])


@pytest.mark.parametrize("lists,weighted", [
    ((0,), False), ((0, 1), False), ((0, 1), True),
])
def test_mc_gather_matches_oracle(lists, weighted):
    rng = np.random.default_rng(42 + len(lists) + weighted)
    raw, dpb = make_dpb(rng)
    assert_matches_oracle(make_abi(rng, lists=lists, weighted=weighted),
                          raw, dpb)


@pytest.mark.parametrize("lists,weighted", [
    ((0,), False), ((0, 1), True),
])
def test_mc_gather_wild_mvs_match_oracle(lists, weighted):
    """~5% of cells point far outside the picture (well past the padded
    planes): clamped reads must equal the spec's edge extension."""
    rng = np.random.default_rng(11 + len(lists))
    raw, dpb = make_dpb(rng)
    abi = make_abi(rng, lists=lists, weighted=weighted)
    n = MB_W * MB_H
    wild = rng.random((n, 4, 4)) < 0.05
    wmv = rng.integers(-500, 500, (n, 4, 4, 2, 2)).astype(np.int32)
    abi["mv"] = np.where(wild[..., None, None], wmv, abi["mv"])
    assert_matches_oracle(abi, raw, dpb)


def test_mc_chroma_uniform_mv_coordinate_plane():
    """Uniform MV over a coordinate-encoded chroma plane: catches
    systematic row/col offsets that random content can mask."""
    r = np.arange(H // 2)[:, None]
    c = np.arange(W // 2)[None, :]
    plane = ((r * 3 + c * 7) % 256).astype(np.uint8)
    zero_y = np.zeros((H, W), np.uint8)
    _, dpb = make_dpb(None, planes=[(zero_y, plane, plane)])
    n = MB_W * MB_H
    abi = {"mv": np.zeros((n, 4, 4, 2, 2), np.int32),
           "refslot": np.full((n, 4, 4, 2), -1, np.int32),
           "wp": np.zeros((n, 4, 4, 2, 3, 2), np.int32),
           "logwd": np.zeros((n, 2), np.int32)}
    abi["wp"][..., 0] = 1
    abi["mv"][..., 0, :] = [12, 8]        # dxc=1 xf=4, dyc=1 yf=0
    abi["refslot"][..., 0] = 0
    _, got_cb, got_cr = inter_predict_packed(
        {k: jnp.asarray(v) for k, v in abi.items()}, *dpb, MB_W, MB_H)

    def exp(y, x):
        yy = min(y + 1, H // 2 - 1)
        A = int(plane[yy, min(x + 1, W // 2 - 1)])
        B = int(plane[yy, min(x + 2, W // 2 - 1)])
        return (32 * A + 32 * B + 32) >> 6

    want = np.array([[exp(y, x) for x in range(W // 2)]
                     for y in range(H // 2)])
    for got in (got_cb, got_cr):
        got = np.asarray(got)
        assert (got == want).all(), np.argwhere(got != want)[:4]


def test_mc_zero_mvs_reproduce_reference():
    """Zero MVs must reproduce the reference pixels exactly."""
    rng = np.random.default_rng(7)
    raw, dpb = make_dpb(rng)
    abi = make_abi(rng, lists=(0,))
    abi["mv"][:] = 0
    abi["refslot"][..., 0] = 1
    got_y, got_cb, got_cr = inter_predict_packed(
        {k: jnp.asarray(v) for k, v in abi.items()}, *dpb, MB_W, MB_H)
    for got, want in zip((got_y, got_cb, got_cr), raw[1]):
        assert (np.asarray(got) == want).all()


def test_mc_batch_matches_single():
    """B=3 stream-batched gather MC (vmap) == per-stream calls."""
    abis, dpbs = [], []
    for b in range(3):
        rng = np.random.default_rng(900 + b)
        _, dpb = make_dpb(rng)
        abi = make_abi(rng, lists=(0, 1), weighted=(b % 2 == 1))
        abis.append({k: jnp.asarray(v) for k, v in abi.items()})
        dpbs.append(dpb)
    abi_b = {k: jnp.stack([a[k] for a in abis]) for k in abis[0]}
    got = jax.vmap(lambda a, y, c: inter_predict_packed(a, y, c, MB_W, MB_H))(
        abi_b, jnp.stack([d[0] for d in dpbs]),
        jnp.stack([d[1] for d in dpbs]))
    for b in range(3):
        single = inter_predict_packed(abis[b], *dpbs[b], MB_W, MB_H)
        for g, r, name in zip(got, single, ("y", "cb", "cr")):
            assert (np.asarray(g[b]) == np.asarray(r)).all(), (b, name)


# ---------------------------------------------------------------------------
# host-side mode lattice (models.pipeline.select_inter_mode)
# ---------------------------------------------------------------------------

def test_select_inter_mode_evicts_to_patch():
    from arrow_h264_tpu.models.pipeline import select_inter_mode
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    abi = synthetic_abi_p(MB_W, MB_H, seed=3, n_slots=2, n_mv=8)
    # in-envelope baseline
    m0, sl0, p0 = select_inter_mode(abi, MB_W, MB_H)
    assert m0 == "pl0" and (p0 == -1).all()
    # blow the envelope on three cells -> patched mode, not gather
    abi["mv"][1, 0, 0, 0] = [999, -999]
    abi["mv"][5, 2, 1, 0] = [-800, 0]
    abi["mv"][7, 3, 3, 0] = [0, 700]
    for mb in (1, 5, 7):
        abi["kind"][mb] = 4
        abi["refslot"][mb, ..., 0] = 0
    m, sl, patch = select_inter_mode(abi, MB_W, MB_H)
    assert m == "pl0p"
    got = set(patch[patch >= 0].tolist())
    assert got == {1 * 16 + 0 * 4 + 0, 5 * 16 + 2 * 4 + 1, 7 * 16 + 3 * 4 + 3}


def test_select_inter_mode_slot_pressure_to_patch():
    from arrow_h264_tpu.models.pipeline import select_inter_mode
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    abi = synthetic_abi_p(MB_W, MB_H, seed=4, n_slots=4, n_mv=8)
    # a 5th slot on two cells: evicted to patch, not a gather demotion
    abi["kind"][2] = abi["kind"][3] = 4
    abi["refslot"][2, ..., 0] = np.maximum(abi["refslot"][2, ..., 0], 0)
    abi["refslot"][3, ..., 0] = np.maximum(abi["refslot"][3, ..., 0], 0)
    abi["refslot"][2, 1, 1, 0] = 9
    abi["refslot"][3, 0, 2, 0] = 9
    m, sl, patch = select_inter_mode(abi, MB_W, MB_H)
    assert m == "pl0p"
    assert 9 not in set(sl.tolist())
    got = set(patch[patch >= 0].tolist())
    assert got == {2 * 16 + 1 * 4 + 1, 3 * 16 + 0 * 4 + 2}
