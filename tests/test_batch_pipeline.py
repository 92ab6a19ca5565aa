"""The stream-batched pipeline (decode_frames_batch_fn, one vmapped
program over B lanes) equals the per-stream decode_frame_fn lane by lane,
for the intra-only and the gather-MC program."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from arrow_h264_tpu.models.pipeline import (
    ABI_DEVICE_KEYS, decode_frame_fn, decode_frames_batch_fn, dpb_alloc,
    store_ref_fn,
)
from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
from arrow_h264_tpu.ops.transforms import make_ws_consts

MB_W, MB_H = 4, 3
B = 3


@pytest.mark.parametrize("inter", [False, True])
def test_batch_matches_per_stream(inter):
    H, W = MB_H * 16, MB_W * 16
    ws4, ws8 = make_ws_consts([[16] * 16] * 6, [[16] * 64] * 2)
    kw = dict(mb_w=MB_W, mb_h=MB_H, ws4=jnp.asarray(ws4),
              ws8=jnp.asarray(ws8), cqp_off=(0, 0), inter=inter)
    rng = np.random.default_rng(31)
    abis, dpbs = [], []
    for b in range(B):
        abi = (synthetic_abi_p(MB_W, MB_H, seed=b, n_slots=2) if inter
               else synthetic_abi(MB_W, MB_H, seed=b))
        abis.append({k: jnp.asarray(abi[k]) for k in ABI_DEVICE_KEYS})
        dpb = dpb_alloc(MB_W, MB_H, 2)
        for s in range(2):
            dpb = store_ref_fn(
                *dpb, s,
                jnp.asarray(rng.integers(0, 256, (H, W), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)))
        dpbs.append(dpb)
    abi_b = {k: jnp.stack([a[k] for a in abis]) for k in ABI_DEVICE_KEYS}
    got = decode_frames_batch_fn(abi_b, jnp.stack([d[0] for d in dpbs]),
                                 jnp.stack([d[1] for d in dpbs]), **kw)
    single = functools.partial(decode_frame_fn, **kw)
    for b in range(B):
        want = single(abis[b], *dpbs[b])
        for g, w, name in zip(got, want, ("y", "cb", "cr")):
            assert g.dtype == jnp.uint8
            assert np.array_equal(np.asarray(g[b]), np.asarray(w)), (b, name)
