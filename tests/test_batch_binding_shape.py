"""Binding-shape lockstep decode: a multi-GOP 720p
batch through the full wire path, where spec growth, bucket ladders and
the sharded store actually happen (the 64x64 lockstep tests never leave
the smallest wire buckets).

Marked slow: XLA:CPU compiles of the 720p pipeline dominate the first
run; the persistent compile cache keeps re-runs fast.
"""

import numpy as np
import jax
import pytest

from tools import streams


@pytest.mark.slow
def test_batch_720p_two_gops_wire_sticky(h264ref, tmp_path):
    from arrow_h264_tpu.ops import wire
    from arrow_h264_tpu.parallel.batch import BatchDecoder

    w, h, frames, gop = 1280, 720, 20, 10   # >= 2 GOPs
    n = len(jax.devices())
    paths = []
    for i in range(n):
        yuv = streams.make_content(w, h, frames, seed=300 + i, noise=3)
        p = str(tmp_path / f"s{i}.264")
        streams.encode(yuv, w, h, p, [
            "profile=high", "qp=30", f"g={gop}", "bf=2", "refs=3",
            "keyint_min=" + str(gop),
            "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:"
            "b-pyramid=0:" + streams.X264_COMMON])
        paths.append(p)
    datas = [open(p, "rb").read() for p in paths]
    goldens = [streams.golden_decode(p)[0] for p in paths]

    info0 = wire.unpack_fn.cache_info()
    bd = BatchDecoder(n)
    outs = bd.decode(datas)
    assert all(e is None for e in bd.errors), bd.errors

    # bit-exactness at the binding shape
    for i, (frs, golden) in enumerate(zip(outs, goldens)):
        ours = np.stack([np.frombuffer(f.planar(), np.uint8) for f in frs])
        assert np.array_equal(ours, golden), f"stream {i} mismatch"

    # sticky-spec convergence: the merged wire spec may only GROW, and
    # each growth is one new unpack structure (one jit trace).  The
    # sticky spec is per CLASS (ops.wire.spec_class: dense I-rounds vs
    # sparse P/B-rounds), so the budget is (a few growths) x 2 classes —
    # a flapping spec would recompile the sharded pipeline every round
    # (round-3 sticky-spec design goal).
    info1 = wire.unpack_fn.cache_info()
    new_specs = info1.misses - info0.misses
    assert new_specs <= 10, f"wire spec flapped: {new_specs} distinct specs"
    # the program set is CLOSED: intra-only rounds and rounds with any
    # inter lane, two programs regardless of round count
    assert set(bd._fns) <= {False, True}, sorted(bd._fns)

    # determinism of convergence: an identical second decode must reuse
    # every unpack structure the first one traced (zero new misses) —
    # growth that differed run-to-run WOULD be flapping
    bd2 = BatchDecoder(n)
    outs2 = bd2.decode(datas)
    assert all(e is None for e in bd2.errors), bd2.errors
    info2 = wire.unpack_fn.cache_info()
    assert info2.misses == info1.misses, \
        f"non-deterministic spec growth: {info2.misses - info1.misses} new"
    for i, (frs, golden) in enumerate(zip(outs2, goldens)):
        ours = np.stack([np.frombuffer(f.planar(), np.uint8) for f in frs])
        assert np.array_equal(ours, golden), f"stream {i} 2nd-run mismatch"
