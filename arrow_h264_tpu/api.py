"""Public decode API (SURVEY.md §1 L7).

Reference parity: arrow-h264's public decode surface (exact names unknown —
reference mount empty, SURVEY.md §0/§7 API-surface note): a decoder object,
an Annex-B one-shot helper, and a batch entry point.

    dec = Decoder()
    for frame in dec.decode_annexb(stream_bytes):
        frame.y, frame.cb, frame.cr, frame.planar()

The host entropy layer (bitstream + mb.parse) runs on CPU; reconstruction
runs as jitted JAX on the accelerator (models.pipeline).
"""

from __future__ import annotations

import time

from dataclasses import dataclass, field

import numpy as np

from .bitstream import nal
from .bitstream.bits import BitReader
from .bitstream.params import PPS, SPS, parse_pps, parse_sps
from .bitstream.sei import SEIMessage, parse_sei_rbsp
from .bitstream.slicehdr import parse_slice_header
from .dpb import DPB
from .host import centropy
from .mb.parse import PictureParse
from .models.pipeline import DevicePipeline
from .oracle.decoder import crop_planes
from .ops.abi import pack_frame
from .bitstream.bits import TracingBitReader
from .conceal import conceal_abi, nearest_ref_slot, slice_coverage
from .trace import (
    dump_se_log, trace_frame_abi, trace_se_target, trace_slice_header,
    trace_target,
)


@dataclass
class Frame:
    y: np.ndarray
    cb: np.ndarray
    cr: np.ndarray
    poc: int = 0

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    def planar(self) -> bytes:
        """Planar YUV420 bytes (the JM-comparison format)."""
        return (self.y.tobytes() + self.cb.tobytes() + self.cr.tobytes())


class PendingFrame:
    """An output frame whose planes are still device arrays.

    Batched decode (parallel.batch.BatchDecoder) defers the
    device->host sync: per-frame `np.asarray` pays the transport
    round-trip latency once PER FRAME, which on a high-latency link
    caps end-to-end throughput regardless of compute.  Instead the
    batch layer starts one async copy per round (`start_fetch`) and
    materializes a round later (`finalize`), overlapping the wire
    with the next round's host entropy parse.

    `bottom`: for PAFF field pairs, the bottom field's (y, cb, cr);
    finalize() weaves the two fields into one progressive frame."""

    __slots__ = ("y", "cb", "cr", "sps", "poc", "bottom")

    def __init__(self, y, cb, cr, sps, poc, bottom=None):
        self.y, self.cb, self.cr = y, cb, cr
        self.sps, self.poc = sps, poc
        self.bottom = bottom

    def start_fetch(self) -> None:
        arrs = (self.y, self.cb, self.cr) + (self.bottom or ())
        for a in arrs:
            fn = getattr(a, "copy_to_host_async", None)
            if fn is not None:
                fn()

    def finalize(self) -> Frame:
        y = np.asarray(self.y)
        cb = np.asarray(self.cb)
        cr = np.asarray(self.cr)
        if self.bottom is not None:
            y, cb, cr = _weave_planes(
                (y, cb, cr), tuple(np.asarray(a) for a in self.bottom))
        y, cb, cr = crop_planes(self.sps, y, cb, cr)
        return Frame(y=y, cb=cb, cr=cr, poc=self.poc)


def _weave_planes(top, bottom):
    """Interleave top/bottom field rows into progressive planes."""
    out = []
    for t, b in zip(top, bottom):
        t = np.asarray(t)
        b = np.asarray(b)
        w = np.empty((t.shape[0] + b.shape[0],) + t.shape[1:], t.dtype)
        w[0::2] = t
        w[1::2] = b
        out.append(w)
    return tuple(out)


@dataclass
class DecodeStats:
    """Per-decoder counters (SURVEY.md par.5 metrics/logging row)."""
    frames: int = 0
    host_parse_s: float = 0.0       # entropy + header + DPB bookkeeping
    device_dispatch_s: float = 0.0  # async submission of reconstruction
    emit_sync_s: float = 0.0        # device->host sync at output time
    concealed_mbs: int = 0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        wall = self.host_parse_s + self.device_dispatch_s +             self.emit_sync_s
        d["fps_wall"] = round(self.frames / wall, 2) if wall else 0.0
        return d


class Decoder:
    """H.264 decoder (Baseline/Main/High, configs 1-4).

    entropy="cpp" uses the native host entropy library (the shipped
    component); "python" uses the pure-Python differential oracle parser.
    """

    def __init__(self, entropy: str = "cpp", trace=None,
                 conceal: bool = False, trace_se=None) -> None:
        self._trace = trace_target(trace)
        self._trace_se = trace_se_target(trace_se)
        # SE-level tracing works on BOTH engines: the Python oracle via
        # TracingBitReader, the shipped C++ engine via a -DH264E_TRACE
        # build whose records are converted to the same log format
        # (differential-tested equal in test_trace_se)
        self._frame_idx = 0
        self.conceal = conceal
        self.concealed: list[tuple[int, int]] = []
        self.stats = DecodeStats()
        self.sps_map: dict[int, SPS] = {}
        self.pps_map: dict[int, PPS] = {}
        self._pipelines: dict[tuple, DevicePipeline] = {}
        self.dpb: DPB | None = None
        self._dpb_sps_id: int | None = None
        self.sei_messages: list[SEIMessage] = []
        if entropy == "cpp":
            try:
                centropy.load_lib()
            except Exception:
                entropy = "python"
        self.entropy = entropy
        self._pic_pool = centropy.PicBufPool()
        self._gap_bumped: list = []
        # set by BatchDecoder: _emit returns PendingFrame (no sync)
        self.deferred_emit = False

    def _pipeline(self, sps: SPS, pps: PPS) -> DevicePipeline:
        key = (sps.seq_parameter_set_id, pps.pic_parameter_set_id,
               sps.pic_width_in_mbs, sps.pic_height_in_map_units)
        if key not in self._pipelines:
            self._pipelines[key] = DevicePipeline(sps, pps)
        return self._pipelines[key]

    def decode_annexb(self, data: bytes):
        """Yield Frames in output order."""
        gen = self.parse_pictures(data)
        while True:
            t0 = time.perf_counter()
            try:
                pic, poc = next(gen)
            except StopIteration:
                self.stats.host_parse_s += time.perf_counter() - t0
                break
            self.stats.host_parse_s += time.perf_counter() - t0
            yield from self._finish(pic, poc)
        if self.dpb is not None:
            for planes in self.dpb.flush():
                yield self._emit(planes)

    def parse_pictures(self, data: bytes):
        """Yield (PictureParse, poc) per complete coded picture.

        The generator suspends after each picture and before the next
        picture's reference-list construction, so the caller MUST store
        the decoded picture into self.dpb (via _finish or equivalent)
        before resuming — this is what lets the batched lockstep driver
        interleave host parse with batched device reconstruction.

        With self.conceal, slice-level parse errors are swallowed (the
        affected MBs are repaired later by _finish via conceal_abi);
        without it they propagate.
        """
        cur: PictureParse | None = None
        cur_poc = 0
        prev_hdr = None
        for u in nal.parse_annexb(data):
            if u.nal_unit_type == nal.NAL_SPS:
                sp = parse_sps(u.rbsp)
                self.sps_map[sp.seq_parameter_set_id] = sp
            elif u.nal_unit_type == nal.NAL_PPS:
                pp = parse_pps(u.rbsp, self.sps_map)
                self.pps_map[pp.pic_parameter_set_id] = pp
            elif u.nal_unit_type == nal.NAL_SEI:
                sps0 = next(iter(self.sps_map.values()), None)
                self.sei_messages.extend(parse_sei_rbsp(u.rbsp, sps0))
            elif u.is_slice:
                try:
                    r2 = BitReader(u.rbsp)
                    r2.ue()
                    r2.ue()
                    pps = self.pps_map[r2.ue()]
                    sps = self.sps_map[pps.seq_parameter_set_id]
                    se_log: list = []
                    r = (TracingBitReader(u.rbsp, se_log)
                         if self._trace_se is not None else BitReader(u.rbsp))
                    hdr = parse_slice_header(r, sps, pps, u.nal_unit_type,
                                             u.nal_ref_idc)
                except Exception:
                    if self.conceal:
                        continue             # lost slice header
                    raise
                # Picture boundary: without FMO/ASO the first slice of a
                # picture starts at MB 0.  With FMO the first slice can
                # start anywhere (its group's first MB) and with ASO the
                # MB-0 slice may arrive mid-picture, so boundary = any
                # header-field change (spec 7.4.1.2.4 subset) or a slice
                # whose first MB this picture already parsed.
                if pps.num_slice_groups > 1:
                    mbs = getattr(cur, "mbs", None)
                    new_pic = (cur is None or prev_hdr is None
                               or hdr.pic_parameter_set_id !=
                                   prev_hdr.pic_parameter_set_id
                               or hdr.frame_num != prev_hdr.frame_num
                               or hdr.is_idr != prev_hdr.is_idr
                               or (hdr.is_idr and
                                   hdr.idr_pic_id != prev_hdr.idr_pic_id)
                               or hdr.pic_order_cnt_lsb !=
                                   prev_hdr.pic_order_cnt_lsb
                               or hdr.delta_pic_order_cnt !=
                                   prev_hdr.delta_pic_order_cnt
                               or (mbs is not None and
                                   mbs[hdr.first_mb_in_slice] is not None))
                else:
                    new_pic = hdr.first_mb_in_slice == 0
                prev_hdr = hdr
                if new_pic:
                    if cur is not None:
                        yield cur, cur_poc
                        # by the generator contract (docstring above) the
                        # caller has committed `cur` before resuming, so
                        # its parse arrays can go back to the pool (the
                        # pool's refcount gate + min-depth keep anything
                        # still referenced downstream out of reuse)
                        if hasattr(cur, "retire"):
                            cur.retire()
                    if self.dpb is None or self._dpb_sps_id !=                             sps.seq_parameter_set_id:
                        self.dpb = DPB(sps)
                        self._dpb_sps_id = sps.seq_parameter_set_id
                    # FMO pictures ride the C++ engine too: the slice
                    # loop follows a precomputed NextMbAddress table
                    # (SliceParams.next_mb; SURVEY.md §2 FMO row)
                    cur = (centropy.CppPictureParse(
                               sps, pps, pool=self._pic_pool,
                               trace=self._trace_se is not None)
                           if self.entropy == "cpp"
                           else PictureParse(sps, pps))
                    # spec 8.2.5.2: synthesize non-existing refs for
                    # frame_num gaps; bind them to slot 0 so a (non-
                    # conforming) reference to one stays in bounds.  Any
                    # real output-pending pictures bumped by the gap
                    # insertion are queued for emission at the next commit.
                    gap_pics, gap_bumped = self.dpb.fill_frame_num_gaps(hdr)
                    for gp in gap_pics:
                        gp.slot = 0
                    self._gap_bumped.extend(gap_bumped)
                    cur_poc = self.dpb.compute_poc(hdr)
                if cur is None:
                    if self.conceal:
                        continue
                    raise ValueError("slice without picture start")
                try:
                    reflists = ((), ())
                    if hdr.is_p:
                        reflists = (self.dpb.init_list_p(hdr), ())
                    elif hdr.is_b:
                        reflists = self.dpb.init_lists_b(hdr, cur_poc)
                    if self._trace is not None:
                        trace_slice_header(self._trace, hdr, cur_poc,
                                           self._frame_idx)
                    cur.parse_slice(r, hdr, reflists, cur_poc)
                    if self._trace_se is not None:
                        dump_se_log(self._trace_se, se_log, self._frame_idx,
                                    len(cur.headers) - 1)
                except Exception:
                    if self.conceal:
                        continue             # lost slice body
                    raise
        if cur is not None:
            yield cur, cur_poc

    def pack_abi(self, pic, poc: int):
        """Entropy results -> frame ABI (+ optional JSONL trace)."""
        if isinstance(pic, centropy.CppPictureParse):
            abi = centropy.pack_frame_cpp(pic, poc)
        else:
            abi = pack_frame(pic, poc)
        hdr0 = pic.headers[0] if pic.headers else None
        if hdr0 is not None and hdr0.field_pic_flag:
            # per-slot chroma MV adjustment for cross-parity references
            # (spec 8.4.1.4.1; consumed by ops.inter._inter_cells_core)
            cvoff = np.zeros(64, np.int32)
            for l0, l1 in pic.slice_reflists:
                for p in list(l0) + list(l1):
                    # non-existing gap placeholders share slot 0 with a
                    # real picture (api gap binding); letting one set the
                    # slot's parity offset would corrupt the real ref's
                    # chroma MC (conforming streams never reference
                    # non-existing fields, so their own adjustment is
                    # irrelevant)
                    if p.slot >= 0 and p.parity and \
                            not getattr(p, "non_existing", False) and \
                            p.parity != hdr0.parity:
                        cvoff[p.slot] = -2 if hdr0.parity == 1 else 2
            abi["cvoff"] = cvoff
        if self._trace is not None:
            trace_frame_abi(self._trace, abi, pic.sps.pic_width_in_mbs,
                            pic.sps.pic_height_in_map_units,
                            self._frame_idx)
            self._trace.flush()
        self._frame_idx += 1
        return abi

    def commit(self, pic, poc: int, y, cb, cr, n_slots: int, store_ref):
        """DPB store + ref bookkeeping; yields output Frames.

        store_ref(slot, y, cb, cr): writes the picture into the device
        DPB slot (single-stream: pipeline.store_ref; batched: the
        stream's lane of the sharded store)."""
        self.stats.frames += 1
        if self._gap_bumped:
            for planes in self._gap_bumped:
                yield self._emit(planes)
            self._gap_bumped.clear()
        hdr = pic.headers[0]
        # payload keeps DEVICE arrays (no sync): host entropy for the
        # next picture overlaps device reconstruction of this one
        # (SURVEY.md par. row 4); _emit syncs at output time.
        payload = (y, cb, cr, pic.sps, poc)
        outputs, stored = self.dpb.store(payload, hdr, poc)
        if stored.is_ref:
            stored.col_mv, stored.col_refidx, stored.col_ref_uid = \
                pic.build_col_motion()
            used = {p.slot for p in self.dpb.pics
                    if p.is_ref and p is not stored and p.slot >= 0}
            slot = next(s for s in range(n_slots) if s not in used)
            stored.slot = slot
            store_ref(slot, y, cb, cr)
        for planes in outputs:
            yield self._emit(planes)

    def _finish(self, pic, poc: int):
        if self.conceal and not pic.headers:
            return                       # every slice of the picture lost
        abi = self.pack_abi(pic, poc)
        if self.conceal:
            cov = slice_coverage(pic)
            if not cov.all():
                from .conceal import nearest_ref_pic
                ref = nearest_ref_pic(self.dpb, poc)
                n = conceal_abi(abi, cov,
                                -1 if ref is None else ref.slot,
                                col_mv=getattr(ref, "col_mv", None))
                self.concealed.append((self._frame_idx - 1, n))
                self.stats.concealed_mbs += n
        pipeline = self._pipeline(pic.sps, pic.pps)
        t0 = time.perf_counter()
        y, cb, cr = pipeline.decode_frame(abi)   # device arrays (async)
        self.stats.device_dispatch_s += time.perf_counter() - t0
        yield from self.commit(pic, poc, y, cb, cr, pipeline.n_slots,
                               pipeline.store_ref)

    def _emit(self, planes) -> Frame:
        from .dpb import WovenPair
        if isinstance(planes, WovenPair):
            yt, cbt, crt, sps, poct = planes.top
            yb, cbb, crb, _, pocb = planes.bottom
            poc = min(poct, pocb)
            if self.deferred_emit:
                return PendingFrame(yt, cbt, crt, sps, poc,
                                    bottom=(yb, cbb, crb))
            t0 = time.perf_counter()
            top = tuple(np.asarray(a) for a in (yt, cbt, crt))
            bot = tuple(np.asarray(a) for a in (yb, cbb, crb))
            self.stats.emit_sync_s += time.perf_counter() - t0
            y, cb, cr = _weave_planes(top, bot)
            y, cb, cr = crop_planes(sps, y, cb, cr)
            return Frame(y=y, cb=cb, cr=cr, poc=poc)
        y, cb, cr, sps, poc = planes
        if self.deferred_emit:
            return PendingFrame(y, cb, cr, sps, poc)
        t0 = time.perf_counter()
        y, cb, cr = np.asarray(y), np.asarray(cb), np.asarray(cr)
        self.stats.emit_sync_s += time.perf_counter() - t0
        y, cb, cr = crop_planes(sps, y, cb, cr)
        return Frame(y=y, cb=cb, cr=cr, poc=poc)


def decode_annexb(data: bytes):
    """One-shot convenience: bytes -> list[Frame]."""
    return list(Decoder().decode_annexb(data))
