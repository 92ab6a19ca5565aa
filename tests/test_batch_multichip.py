"""Config 5: multi-stream batch decode sharded over an 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from tools import streams


def _make_streams(tmp_path, n, w=64, h=64, frames=3):
    paths = []
    for i in range(n):
        yuv = streams.make_content(w, h, frames, seed=100 + i)
        p = str(tmp_path / f"s{i}.264")
        streams.encode(yuv, w, h, p, streams.CONFIG_OPTS[2])
        paths.append(p)
    datas = [open(p, "rb").read() for p in paths]
    goldens = [streams.golden_decode(p)[0] for p in paths]
    return datas, goldens


def test_batch_decoder_streams(h264ref, tmp_path):
    """Real streams through the LOCKSTEP SHARDED path (8-device mesh),
    bit-exact each (BASELINE config 5)."""
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    n = len(jax.devices())
    datas, goldens = _make_streams(tmp_path, n)
    bd = BatchDecoder(n)
    assert bd.mesh.devices.size == n, "must exercise the full mesh"
    outs = bd.decode(datas)
    assert all(e is None for e in bd.errors), bd.errors
    for i, (frames, golden) in enumerate(zip(outs, goldens)):
        ours = np.stack([np.frombuffer(f.planar(), np.uint8) for f in frames])
        assert np.array_equal(ours, golden), f"stream {i} mismatch"


def test_batch_decoder_error_isolation(h264ref, tmp_path):
    """A corrupt lane is flagged, not fatal (SURVEY.md §5)."""
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    n = len(jax.devices())
    datas, goldens = _make_streams(tmp_path, n)
    bad = 2
    datas[bad] = datas[bad][:len(datas[bad]) // 2] + b"\x00\x17" * 40
    bd = BatchDecoder(n)
    outs = bd.decode(datas)
    assert bd.errors[bad] is not None
    for i in range(n):
        if i == bad:
            continue
        assert bd.errors[i] is None, (i, bd.errors[i])
        ours = np.stack([np.frombuffer(f.planar(), np.uint8)
                         for f in outs[i]])
        assert np.array_equal(ours, goldens[i]), f"stream {i} mismatch"


def test_batch_decoder_per_lane_demotion(h264ref, tmp_path, monkeypatch):
    """A wild lane (one whose cells overflow the host mode lattice, so
    select_inter_mode labels its inter frames "gather") rides the
    round's batched launch like every other lane: the decoder compiles
    only the intra-only and the inter program, and every lane stays
    bit-exact."""
    import arrow_h264_tpu.parallel.batch as batch_mod
    from arrow_h264_tpu.parallel.batch import BatchDecoder

    n = len(jax.devices())
    datas, goldens = _make_streams(tmp_path, n)
    wild = 3
    real_select = batch_mod.select_inter_mode
    bd = BatchDecoder(n)

    # tag the wild lane's ABIs so the forced selector can identify them
    # (pack() runs in a thread pool, so call order is not lane order)
    wild_ids = set()
    orig_pack = bd.decoders[wild].pack_abi

    def tag_pack(pic, poc):
        abi = orig_pack(pic, poc)
        wild_ids.add(id(abi))
        return abi

    bd.decoders[wild].pack_abi = tag_pack
    forced_rounds = []

    def forced(abi, mb_w, mb_h):
        # the label select_inter_mode gives when len(evictions) exceeds
        # the patch capacity
        mode, sl, patch = real_select(abi, mb_w, mb_h)
        if id(abi) in wild_ids and mode != "none":
            forced_rounds.append(1)
            return "gather", np.full_like(sl, -1), np.full_like(patch, -1)
        return mode, sl, patch

    monkeypatch.setattr(batch_mod, "select_inter_mode", forced)
    outs = bd.decode(datas)
    assert all(e is None for e in bd.errors), bd.errors
    assert forced_rounds, "the wild lane must have inter frames"
    assert set(bd._fns) == {False, True}, sorted(bd._fns)
    for i, (frames, golden) in enumerate(zip(outs, goldens)):
        ours = np.stack([np.frombuffer(f.planar(), np.uint8) for f in frames])
        assert np.array_equal(ours, golden), f"stream {i} mismatch"


def test_lockstep_sharded_step():
    """Sharded lockstep reconstruction over the 8-device mesh (P-frames
    through the gather MC path)."""
    from arrow_h264_tpu.parallel.batch import decode_batch_lockstep
    from arrow_h264_tpu.parallel.sharding import make_stream_mesh, \
        sharded_decode_fn
    from arrow_h264_tpu.ops.synthetic import synthetic_abi_p
    from arrow_h264_tpu.ops.transforms import make_ws_consts
    from arrow_h264_tpu.models.pipeline import dpb_alloc, store_ref_fn
    import jax.numpy as jnp

    n = len(jax.devices())
    assert n == 8, f"conftest should provide 8 cpu devices, got {n}"
    mesh = make_stream_mesh()
    mb_w, mb_h = 2, 2
    H, W = mb_h * 16, mb_w * 16
    ws4, ws8 = make_ws_consts([[16] * 16] * 6, [[16] * 64] * 2)
    fn = sharded_decode_fn(mesh, mb_w, mb_h, ws4, ws8, inter=True)
    abis = [synthetic_abi_p(mb_w, mb_h, seed=i, n_mv=6) for i in range(n)]
    rng = np.random.default_rng(5)
    dpbs = []
    for i in range(n):
        dpb = dpb_alloc(mb_w, mb_h, 2)
        for s in range(2):
            dpb = store_ref_fn(
                *dpb, s,
                jnp.asarray(rng.integers(0, 256, (H, W), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)))
        dpbs.append(dpb)
    y, cb, cr = decode_batch_lockstep(fn, abis, dpbs, mesh)
    assert y.shape == (n, H, W)
    # sharded result must equal per-stream unsharded decode
    from arrow_h264_tpu.models.pipeline import decode_frame_fn, ABI_DEVICE_KEYS
    import functools
    single = functools.partial(decode_frame_fn, mb_w=mb_w, mb_h=mb_h,
                               ws4=jnp.asarray(ws4), ws8=jnp.asarray(ws8),
                               cqp_off=(0, 0), inter=True)
    for i in range(n):
        dev = {k: jnp.asarray(abis[i][k]) for k in ABI_DEVICE_KEYS}
        ys, cbs, crs = single(dev, *dpbs[i])
        assert np.array_equal(np.asarray(y[i]), np.asarray(ys)), f"stream {i}"


def test_batch_decoder_device_resident(h264ref, tmp_path):
    """materialize=False keeps outputs as device-resident PendingFrames
    (the on-device consumer path; bench.py's device-resident line);
    finalize() must still reproduce the golden bytes."""
    from arrow_h264_tpu.api import PendingFrame
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    n = len(jax.devices())
    datas, goldens = _make_streams(tmp_path, n)
    bd = BatchDecoder(n, materialize=False)
    outs = bd.decode(datas)
    assert all(e is None for e in bd.errors), bd.errors
    for i, (frames, golden) in enumerate(zip(outs, goldens)):
        assert all(isinstance(f, PendingFrame) for f in frames), i
        mats = [f.finalize() for f in frames]
        ours = np.stack([np.frombuffer(f.planar(), np.uint8) for f in mats])
        assert np.array_equal(ours, golden), f"stream {i} mismatch"


def test_batch_decoder_on_frame_streaming(h264ref, tmp_path):
    """on_frame consumes each output frame the moment its round commits
    (bounding device residency to DPB + one round — bench.py's
    device-resident stage); every frame must arrive exactly once, in
    output order, still bit-exact."""
    from arrow_h264_tpu.api import PendingFrame
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    n = len(jax.devices())
    datas, goldens = _make_streams(tmp_path, n)
    seen: list[list] = [[] for _ in range(n)]

    def consume(i, f):
        assert isinstance(f, PendingFrame)
        seen[i].append(f.finalize())
        return None                      # drop: decode() keeps nothing

    bd = BatchDecoder(n, materialize=False, on_frame=consume)
    outs = bd.decode(datas)
    assert all(e is None for e in bd.errors), bd.errors
    for i, golden in enumerate(goldens):
        assert all(f is None for f in outs[i]), i
        assert len(seen[i]) == len(golden), i
        ours = np.stack([np.frombuffer(f.planar(), np.uint8)
                         for f in seen[i]])
        assert np.array_equal(ours, golden), f"stream {i} mismatch"
