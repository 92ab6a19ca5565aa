"""Config 5: batched multi-stream decode sharded across a device mesh.

Reference parity: the reference decoder is single-stream (SURVEY.md §2);
the scale-out axis here is DATA PARALLELISM over independent streams:
host entropy parses each stream (embarrassingly parallel across host
cores), pictures are grouped into lockstep rounds, and ONE jitted sharded
reconstruction step decodes the whole round with the stream axis sharded
over the `stream` mesh (no collectives in the decode path).  Reference
stores go through a matching sharded step into stacked per-stream DPB
slots (plus one trash slot for non-reference rounds).

Per-stream error isolation (SURVEY.md §5 failure detection): a stream
that raises during host parse or commit is marked failed and dropped from
subsequent rounds; the other streams keep decoding.  `BatchDecoder.errors`
records the exception per failed stream.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api import Decoder, Frame
from ..models.pipeline import (
    ABI_DEVICE_KEYS, dpb_alloc, make_ws_consts, select_inter_mode,
)
from ..ops.abi import empty_frame_abi


def _dense_weights(abi) -> tuple[np.ndarray, np.ndarray]:
    """Per-cell (wp [n,4,4,2,3,2], logwd [n,2]) for one lane: the host
    twin of models.pipeline.resolve_weights, or the lane's own dense
    weights after a slice-row overflow (ops.abi._fill_dense_weights)."""
    if "wp" in abi:
        return np.asarray(abi["wp"]), np.asarray(abi["logwd"])
    sid = np.asarray(abi["slice_id"])
    ridx = np.asarray(abi["refidx"])
    r0 = np.clip(ridx[..., 0], -1, 31) + 1
    r1 = np.clip(ridx[..., 1], -1, 31) + 1
    t = np.asarray(abi["wtab"]).astype(np.int32)[sid[:, None, None], r0, r1]
    return (np.stack([t[..., 0:2], t[..., 2:4]], axis=3),
            np.asarray(abi["slogwd"])[sid])


class BatchDecoder:
    """Decode N same-resolution streams in lockstep, batch-sharded."""

    def __init__(self, n_streams: int, mesh: Mesh | None = None,
                 entropy: str = "cpp", materialize: bool = True,
                 on_frame=None):
        if mesh is None:
            n_dev = max(1, len(jax.devices()))
            use = n_dev if n_streams % n_dev == 0 else 1
            mesh = Mesh(np.array(jax.devices()[:use]), ("stream",))
        self.mesh = mesh
        self.n_streams = n_streams
        # materialize=False keeps output planes as device-resident
        # api.PendingFrame objects (caller finalizes or consumes them
        # on device — e.g. feeding another device model)
        self.materialize = materialize
        # on_frame(lane, frame) -> value: streaming consumer.  Each
        # newly emitted frame is handed over the moment its round
        # commits and REPLACED in the returned list by on_frame's
        # return value, so decode()'s peak HBM residency is bounded by
        # the DPB + one round instead of every output frame (a 32-lane
        # 1080p batch holds multi-GB of outputs otherwise).  Requires
        # materialize=False (frames arrive as device PendingFrames).
        self.on_frame = on_frame
        assert on_frame is None or not materialize, \
            "on_frame streams device frames; use materialize=False"
        self.decoders = [Decoder(entropy=entropy) for _ in range(n_streams)]
        for d in self.decoders:
            # one overlapped device->host copy per ROUND instead of a
            # blocking np.asarray per FRAME (api.PendingFrame): the
            # per-frame sync would serialize host parse behind it
            d.deferred_emit = True
        self._sharding = NamedSharding(mesh, P("stream"))
        self.errors: list = [None] * n_streams
        self._geom = None
        # host entropy parse is embarrassingly parallel across streams:
        # the C++ slice parser runs with the GIL released (ctypes), so
        # worker threads scale it across host cores (SURVEY.md §2 host
        # parallelism row).  1 worker on a 1-core host degenerates to the
        # serial path.
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, min(n_streams, os.cpu_count() or 1)))

    @property
    def stats(self):
        """Aggregated per-stream DecodeStats (dicts)."""
        return [d.stats.as_dict() for d in self.decoders]

    # ---- batched device state --------------------------------------------

    def _init_device(self, sps, pps):
        from ..parallel.sharding import sharded_decode_fn, sharded_store_fn
        mb_w = sps.pic_width_in_mbs
        mb_h = sps.pic_height_in_map_units
        self._geom = (mb_w, mb_h)
        sl4 = pps.scaling_lists_4x4 if pps.scaling_lists_4x4 is not None \
            else sps.scaling_lists_4x4
        sl8 = pps.scaling_lists_8x8 if pps.scaling_lists_8x8 is not None \
            else sps.scaling_lists_8x8
        self._ws = make_ws_consts(sl4, sl8)
        self._cqp = (pps.chroma_qp_index_offset, pps.chroma_qp_offset(1))
        per_frame = 1 if sps.frame_mbs_only_flag else 2
        self.n_slots = max(2, min(sps.max_num_ref_frames * per_frame,
                                  32) + 1)
        B = self.n_streams
        n_alloc = self.n_slots + 1

        def alloc():
            # zeros made shard by shard on their own devices
            y, c = dpb_alloc(mb_w, mb_h, n_alloc)
            return (jnp.broadcast_to(y, (B,) + y.shape),
                    jnp.broadcast_to(c, (B,) + c.shape))

        self._dpb_y, self._dpb_c = jax.jit(
            alloc, out_shardings=(self._sharding, self._sharding))()
        self._fns = {}
        bypass = bool(sps.qpprime_y_zero_transform_bypass_flag)
        self._field = not sps.frame_mbs_only_flag
        self._mk_fn = lambda inter: sharded_decode_fn(
            self.mesh, mb_w, mb_h, *self._ws, cqp_off=self._cqp,
            n_streams=B, inter=inter, bypass=bypass, field=self._field)
        self._store = sharded_store_fn(self.mesh, B)
        self._dummy = empty_frame_abi(mb_w, mb_h)
        self._use_wire = os.environ.get("ARROW_H264_WIRE") != "0"
        # seed the per-class sticky specs from the on-disk cache: repeat
        # runs then compile the SAME settled structures and hit the
        # persistent XLA compile cache instead of walking a fresh
        # spec-growth sequence of compiles (ops.wire.load_sticky_specs)
        from ..ops.wire import load_sticky_specs
        self._spec_sticky: dict = load_sticky_specs(mb_w, mb_h)
        if self._use_wire:
            from ..ops.wire import pack_wire_raw
            self._dummy_wire = pack_wire_raw(self._dummy, mb_w, mb_h)

    def _decode_fn(self, inter: bool):
        """One compiled program per kind of round: intra-only, or with
        gather MC (any lane has an inter MB)."""
        if inter not in self._fns:
            self._fns[inter] = self._mk_fn(inter)
        return self._fns[inter]

    def _dense_batch(self, abis: dict) -> dict:
        """Per-key dense upload of a round (ARROW_H264_WIRE=0, or a round
        with a slice-row-overflow lane whose dense per-cell weights the
        wire cannot carry: then every lane ships dense weights)."""
        rows = [abis.get(i, self._dummy) for i in range(self.n_streams)]
        dense_w = any("wp" in a for a in rows)
        keys = [k for k in ABI_DEVICE_KEYS
                if not (dense_w and k in ("wtab", "slogwd"))]
        if self._field:
            keys.append("cvoff")
        zero_cv = np.zeros(64, np.int32)
        batch = {k: np.stack([np.asarray(a.get(k, zero_cv)) for a in rows])
                 for k in keys}
        if dense_w:
            ws = [_dense_weights(a) for a in rows]
            batch["wp"] = np.stack([w for w, _ in ws])
            batch["logwd"] = np.stack([lw for _, lw in ws])
        return jax.device_put(batch, self._sharding)

    # ---- lockstep decode --------------------------------------------------

    def decode(self, streams: list[bytes]) -> list[list[Frame]]:
        """Decode the Annex-B streams in lockstep through the sharded
        reconstruction + store steps; returns per-stream frame lists.
        Failed streams yield partial lists; see self.errors."""
        B = self.n_streams
        assert len(streams) == B, (len(streams), B)
        gens = [d.parse_pictures(s)
                for d, s in zip(self.decoders, streams)]
        pending: list = [None] * B
        frames: list[list[Frame]] = [[] for _ in range(B)]
        in_flight: list[tuple[int, int]] = []   # deferred (lane, idx)
        self.errors = [None] * B

        def advance(i):
            if gens[i] is None:
                return
            try:
                pending[i] = next(gens[i])
            except StopIteration:
                gens[i] = None
                pending[i] = None
            except Exception as e:           # corrupt lane: isolate
                self.errors[i] = e
                gens[i] = None
                pending[i] = None

        list(self._pool.map(advance, range(B)))

        use_wire = os.environ.get("ARROW_H264_WIRE") != "0"

        def pack(i):
            pic, poc = pending[i]
            try:
                sps = pic.sps
                mb_w = sps.pic_width_in_mbs
                mb_h = sps.pic_height_in_map_units
                abi = self.decoders[i].pack_abi(pic, poc)
                # mode selection (incl. patch compaction) runs in the
                # parse pool, before the wire pack ships the patch list
                # as a wire section
                mode, _slots, patch = select_inter_mode(abi, mb_w, mb_h)
                abi["patch"] = patch
                ws = None
                if use_wire and "wp" not in abi:
                    # ("wp": slice-row overflow, dense weights that the
                    # wire cannot carry; the round goes dense)
                    from ..ops.wire import pack_wire_raw
                    ws = pack_wire_raw(abi, mb_w, mb_h)
                return i, (abi, ws, mode != "none")
            except Exception as e:
                self.errors[i] = e
                gens[i] = None
                pending[i] = None
                return i, None

        while any(p is not None for p in pending):
            live = [i for i in range(B) if pending[i] is not None]
            abis = {}
            wires = {}
            inter = False
            for i, packed in self._pool.map(pack, live):
                if packed is not None:
                    abis[i], wires[i], lane_inter = packed
                    inter |= lane_inter
            live = [i for i in live if i in abis]
            if not live:
                break
            pic0 = pending[live[0]][0]
            if self._geom is None:
                self._init_device(pic0.sps, pic0.pps)
            mb_w, mb_h = self._geom
            assert (pic0.sps.pic_width_in_mbs,
                    pic0.sps.pic_height_in_map_units) == self._geom, \
                "lockstep streams must share resolution"

            if self._use_wire and all(wires[i] is not None for i in live):
                # bring every lane onto the round's merged wire spec so
                # ONE sharded upload + unpack serves the whole batch
                from ..ops.wire import (
                    emit_wire, merge_specs, spec_class, unpack_fn,
                )
                # sticky across rounds PER CLASS (see
                # DevicePipeline.upload_abi): spec growth is monotone
                # within a class so the sharded decode fn's input
                # structure settles after a few rounds instead of
                # recompiling whenever a coeff class (dis)appears; the
                # class split keeps I-frame rounds' dense schemes from
                # poisoning every P/B round's upload (ops.wire.spec_class)
                target = merge_specs([wires[i][1] for i in live]
                                     + [self._dummy_wire[1]])
                cls = spec_class(target)
                prev = self._spec_sticky.get(cls)
                if prev is not None:
                    target = merge_specs([prev, target])
                if target != prev:
                    # persist each growth immediately: a killed process
                    # must not lose the settled spec
                    from ..ops.wire import save_sticky_specs
                    self._spec_sticky[cls] = target
                    save_sticky_specs(*self._geom, {cls: target})
                n = mb_w * mb_h
                bufs = [emit_wire(*wires.get(i, self._dummy_wire), target, n)
                        for i in range(B)]
                batchw = jax.device_put(np.stack(bufs), self._sharding)
                batch = unpack_fn(mb_w, mb_h, target, batched=True)(batchw)
                if self._field:
                    batch["cvoff"] = jax.device_put(np.stack(
                        [np.asarray(abis[i]["cvoff"]) if i in abis
                         else np.zeros(64, np.int32) for i in range(B)]),
                        self._sharding)
            else:
                batch = self._dense_batch(abis)
            yb, cbb, crb = self._decode_fn(inter)(
                batch, self._dpb_y, self._dpb_c)

            # commit per stream; collect reference stores for one batched
            # sharded store (trash slot self.n_slots for non-storing lanes)
            store_slots = np.full(B, self.n_slots, np.int32)
            mark = [len(frames[i]) for i in range(B)]
            for i in live:
                pic, poc = pending[i]

                def _rec(slot, y, cb, cr, i=i):
                    store_slots[i] = slot

                try:
                    frames[i].extend(self.decoders[i].commit(
                        pic, poc, yb[i], cbb[i], crb[i],
                        self.n_slots, _rec))
                except Exception as e:
                    self.errors[i] = e
                    gens[i] = None
                    pending[i] = None
            self._dpb_y, self._dpb_c = self._store(
                self._dpb_y, self._dpb_c,
                jax.device_put(store_slots, self._sharding),
                yb, cbb, crb)
            abis.clear()   # release ABI views so parse buffers can recycle
            wires.clear()
            todo = [i for i in live if self.errors[i] is None]
            for i in todo:
                pending[i] = None
            # start ONE overlapped device->host copy for this round's
            # emitted frames; materialize LAST round's (whose transfer
            # has been riding the link during this round's device work)
            if self.materialize:
                new_fetch = [(i, j) for i in range(B)
                             for j in range(mark[i], len(frames[i]))]
                for i, j in new_fetch:
                    frames[i][j].start_fetch()
                for i, j in in_flight:
                    frames[i][j] = self._finalize_timed(i, frames[i][j])
                in_flight = new_fetch
            elif self.on_frame is not None:
                for i in range(B):
                    for j in range(mark[i], len(frames[i])):
                        frames[i][j] = self.on_frame(i, frames[i][j])
            # parse the next round's pictures across host cores while the
            # device round above is still executing (pipeline overlap)
            list(self._pool.map(advance, todo))

        for i in range(B):
            if self.errors[i] is None and self.decoders[i].dpb is not None:
                tail = len(frames[i])
                frames[i].extend(self.decoders[i]._emit(p)
                                 for p in self.decoders[i].dpb.flush())
                if self.on_frame is not None:
                    for j in range(tail, len(frames[i])):
                        frames[i][j] = self.on_frame(i, frames[i][j])
        # finalize everything still deferred (tail rounds + DPB flush):
        # start every remaining copy first, then materialize
        if self.materialize:
            from ..api import PendingFrame
            for row in frames:
                for f in row:
                    if isinstance(f, PendingFrame):
                        f.start_fetch()
            for i in range(B):
                frames[i] = [self._finalize_timed(i, f)
                             if isinstance(f, PendingFrame) else f
                             for f in frames[i]]
        return frames

    def _finalize_timed(self, i: int, pending):
        """Materialize a deferred frame, attributing the device->host
        sync to the lane's DecodeStats (deferred emission otherwise
        leaves emit_sync_s at 0 and fps_wall overstates)."""
        import time
        t0 = time.perf_counter()
        f = pending.finalize()
        self.decoders[i].stats.emit_sync_s += time.perf_counter() - t0
        return f


def decode_batch_lockstep(fn, abis: list[dict], dpbs, mesh: Mesh):
    """One lockstep reconstruction step over a sharded stream batch.

    fn: sharded decode fn (parallel.sharding.sharded_decode_fn).
    abis: per-stream ABI dicts (same geometry); dpbs: per-stream packed
    DPB pairs (y4p, cp).
    """
    shard = NamedSharding(mesh, P("stream"))
    batch = {k: np.stack([np.asarray(a[k]) for a in abis])
             for k in ABI_DEVICE_KEYS}
    dpb_y = np.stack([np.asarray(d[0]) for d in dpbs])
    dpb_c = np.stack([np.asarray(d[1]) for d in dpbs])
    return fn(*jax.device_put((batch, dpb_y, dpb_c), shard))
