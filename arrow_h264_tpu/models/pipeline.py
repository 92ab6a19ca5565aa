"""The flagship decode pipeline: MB tensors -> reconstructed frame (JAX).

Reference parity: this is the device half of the JM-lineage
`decode_one_macroblock` + `DeblockPicture` flow (SURVEY.md §3.2), as one
jitted function over the frame's MB tensors:

    residual (batched dequant+IDCT) -> inter MC -> intra -> deblock

Compiled once per (resolution, scaling-list, intra-only/inter) pair.

The DPB lives on device as PACKED u32 half-pel planes (4 px/lane,
ops.inter.pack_u8_plane); the gather MC reads bytes straight out of the
packed words.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream.params import PPS, SPS
from ..ops.abi import KIND_P, FrameABI, patch_capacity
from ..ops.deblock import deblock_planes
from ..ops.inter import (
    CAP, DX_MAX, DX_MIN, DY_MAX, DY_MIN, MAX_SLOTS, PAD, chroma_lanes,
    chroma_rows, halfpel_planes, inter_predict_packed, luma_lanes,
    pack_u8_plane, pad_chroma,
)
from ..ops.intra import intra_reconstruct
from ..ops.transforms import _mb_mask_to_plane, make_ws_consts, residual_planes

ABI_DEVICE_KEYS = (
    "kind", "qp", "luma4", "luma8", "luma_dc", "chroma_dc", "chroma_ac",
    "i4_modes", "i8_modes", "i16_mode", "chroma_mode", "i4_avail", "i8_avail",
    "mb_avail", "pcm", "nz", "tr8", "slice_id", "disable_idc", "alpha_off",
    "beta_off", "mv", "refid", "refslot", "refidx", "wtab", "slogwd",
    "patch",
)


def resolve_weights(abi: dict) -> dict:
    """Expand the compact per-slice weight tables to the per-cell wp/logwd
    arrays the MC combine consumes (one device gather — replaces the
    6.3MB/frame host-filled wp array).  No-op for ABIs that already carry
    dense wp/logwd (kernel unit tests)."""
    if "wtab" not in abi or "wp" in abi:
        return abi
    sid = abi["slice_id"]                                   # [n]
    r0 = jnp.clip(abi["refidx"][..., 0], -1, 31) + 1        # [n,4,4] 0..32
    r1 = jnp.clip(abi["refidx"][..., 1], -1, 31) + 1
    t = abi["wtab"].astype(jnp.int32)[sid[:, None, None], r0, r1]
    wp = jnp.stack([t[..., 0:2], t[..., 2:4]], axis=3)      # [n,4,4,2,3,2]
    out = dict(abi)
    out["wp"] = wp
    out["logwd"] = abi["slogwd"][sid]
    return out


def dpb_alloc(mb_w: int, mb_h: int, n_slots: int):
    """Packed device DPB: (y4p [S,4,Hp,WL] u32, cp [S,2,Hcp,WLc] u32)."""
    H, W = mb_h * 16, mb_w * 16
    return (jnp.zeros((n_slots, 4, H + 2 * PAD, luma_lanes(W)), jnp.uint32),
            jnp.zeros((n_slots, 2, chroma_rows(H), chroma_lanes(W)),
                      jnp.uint32))


def decode_frame_fn(abi: dict, dpb_y4p, dpb_cp, *, mb_w: int, mb_h: int,
                    ws4, ws8, cqp_off, inter: bool = False,
                    bypass: bool = False, field: bool = False):
    """Pure function: ABI dict + packed device DPB -> (y, cb, cr) uint8.

    inter=False compiles the intra-only program (no MC gather); the host
    picks it for pictures without inter MBs (select_inter_mode == "none").
    """
    res_y, res_cb, res_cr = residual_planes(abi, mb_w, mb_h, ws4, ws8,
                                            cqp_off, bypass=bypass)
    H, W = mb_h * 16, mb_w * 16
    if inter:
        pred_y, pred_cb, pred_cr = inter_predict_packed(
            resolve_weights(abi), dpb_y4p, dpb_cp, mb_w, mb_h)
        inter_y = _mb_mask_to_plane(abi["kind"] >= KIND_P, mb_w, mb_h, 16)
        inter_c = _mb_mask_to_plane(abi["kind"] >= KIND_P, mb_w, mb_h, 8)
        init_y = jnp.where(inter_y, jnp.clip(pred_y + res_y, 0, 255), 0)
        init_cb = jnp.where(inter_c, jnp.clip(pred_cb + res_cb, 0, 255), 0)
        init_cr = jnp.where(inter_c, jnp.clip(pred_cr + res_cr, 0, 255), 0)
    else:
        init_y = jnp.zeros((H, W), jnp.int32)
        init_cb = jnp.zeros((H // 2, W // 2), jnp.int32)
        init_cr = init_cb
    y, cb, cr = intra_reconstruct(abi, res_y, res_cb, res_cr, mb_w, mb_h,
                                  init_y, init_cb, init_cr)
    y, cb, cr = deblock_planes(abi, y, cb, cr, mb_w, mb_h, cqp_off,
                               field=field)
    return y.astype(jnp.uint8), cb.astype(jnp.uint8), cr.astype(jnp.uint8)


def decode_frames_batch_fn(abi_b: dict, dpb_y_b, dpb_c_b, *,
                           mb_w: int, mb_h: int, ws4, ws8, cqp_off,
                           inter: bool = False, bypass: bool = False,
                           field: bool = False):
    """Batched decode: [B, ...] stacked ABIs + per-stream DPBs -> stacked
    uint8 planes.  The whole pipeline vmaps over the stream axis: ONE
    traced body regardless of B, so each of the 2*(mb_h-1)+mb_w
    knight-phase steps of intra and deblock serves every lane at once
    (the SURVEY.md §2 stream-batch axis)."""
    fn = functools.partial(decode_frame_fn, mb_w=mb_w, mb_h=mb_h, ws4=ws4,
                           ws8=ws8, cqp_off=cqp_off, inter=inter,
                           bypass=bypass, field=field)
    return jax.vmap(fn)(abi_b, dpb_y_b, dpb_c_b)


def store_ref_fn(dpb_y4p, dpb_cp, slot, y, cb, cr):
    """Compute half-pel planes, pad, pack to u32 lanes, write to the slot.

    Amortizes the 6-tap interpolation once per stored reference frame
    (SURVEY.md §7: MC gathers never touch the host OR recompute filters).
    """
    WL = dpb_y4p.shape[3]
    WLc = dpb_cp.shape[3]
    g, b, h, j = halfpel_planes(y)
    y4 = jnp.stack([pack_u8_plane(p, WL) for p in (g, b, h, j)])[None]
    c2 = jnp.stack([pack_u8_plane(pad_chroma(c), WLc)
                    for c in (cb, cr)])[None]
    return (jax.lax.dynamic_update_slice(dpb_y4p, y4, (slot, 0, 0, 0)),
            jax.lax.dynamic_update_slice(dpb_cp, c2, (slot, 0, 0, 0)))


def select_inter_mode(abi: FrameABI, mb_w: int, mb_h: int):
    """Pick the per-frame MC variant + slot list + patch cells.

    The device program only reads whether the mode is "none" (no inter
    MB: the intra-only program) or not (the gather-MC program).  The
    rest of the lattice is host-side state that predates gather MC: MVs
    outside the DX/DY envelope, more than MAX_SLOTS distinct DPB slots,
    or more than CAP distinct (slot, mv_int) candidates per 16-row band
    evict cells into the `patch` list (a wire section), and a frame whose
    evictions overflow the patch capacity is labelled "gather".

    Dispatches to the C++ scan (centropy.select_inter_mode_cpp, GIL
    released on the parse thread) when the host entropy lib is
    available; select_inter_mode_np is the numpy oracle (the per-band
    np.unique loop held the GIL ~68 bands/frame at 1080p)."""
    try:
        from ..host import centropy
        centropy.load_lib()
    except Exception:
        return select_inter_mode_np(abi, mb_w, mb_h)
    return centropy.select_inter_mode_cpp(
        np.asarray(abi["kind"]), np.asarray(abi["mv"]),
        np.asarray(abi["refslot"]), mb_w, mb_h,
        max_slots=MAX_SLOTS, cap=CAP, dx_min=DX_MIN, dx_max=DX_MAX,
        dy_min=DY_MIN, dy_max=DY_MAX,
        patch_cap=patch_capacity(mb_w, mb_h))


def select_inter_mode_np(abi: FrameABI, mb_w: int, mb_h: int):
    """Numpy oracle for select_inter_mode (differential-tested against
    the C++ scan; stable argsorts pin the eviction tie-breaks both
    implementations share)."""
    n = mb_w * mb_h
    K = patch_capacity(mb_w, mb_h)
    patch = np.full(K, -1, np.int32)
    slot_list = np.full(MAX_SLOTS, -1, np.int32)
    if not bool(np.any(np.asarray(abi["kind"]) >= KIND_P)):
        return "none", slot_list, patch
    refslot = np.asarray(abi["refslot"])        # [n,4,4,2]
    used = refslot >= 0
    mv = np.where(used[..., None], np.asarray(abi["mv"]), 0)
    dxi = mv[..., 0] >> 2
    dyi = mv[..., 1] >> 2
    lists = (0, 1) if used[..., 1].any() else (0,)
    # (a) envelope violations -> per-CELL eviction (a patched cell is
    # recomputed whole, both lists)
    viol = (used & ((dxi < DX_MIN) | (dxi > DX_MAX) |
                    (dyi < DY_MIN) | (dyi > DY_MAX))).any(-1)  # [n,4,4]
    # (b) slot pressure: keep the MAX_SLOTS most-referenced slots
    slots, counts = np.unique(refslot[used], return_counts=True)
    if len(slots) > MAX_SLOTS:
        keep = slots[np.argsort(-counts, kind="stable")][:MAX_SLOTS]
        viol |= (used & ~np.isin(refslot, keep)).any(-1)
        slots = np.sort(keep)
    slot_list[:len(slots)] = slots
    # (c) per-band candidate-CAP overflow: evict rarest candidates
    k = np.zeros_like(refslot)
    for i in range(len(slots)):
        k = np.where(refslot == slots[i], i, k)
    active = used & ~viol[..., None]
    cand = np.where(active, (k << 13) | ((dyi + 32) << 7) | (dxi + 48), -1)
    cand_b = cand.reshape(mb_h, mb_w, 4, 4, 2)
    viol_b = viol.reshape(mb_h, mb_w, 4, 4)
    for band in range(mb_h):
        vals = cand_b[band][cand_b[band] >= 0]
        if not len(vals):
            continue
        u, c = np.unique(vals, return_counts=True)
        if len(u) <= CAP:
            continue
        evict = u[np.argsort(c, kind="stable")][: len(u) - CAP]
        viol_b[band] |= np.isin(cand_b[band], evict).any(-1)
    idx = np.flatnonzero(viol.ravel()).astype(np.int32)
    if len(idx) > K:
        return "gather", slot_list, patch
    mode = "pl0" if lists == (0,) else "pl01"
    if len(idx):
        patch[: len(idx)] = idx
        mode += "p"
    return mode, slot_list, patch


class DevicePipeline:
    """Jit-compiled per (sps, pps) frame reconstruction + device DPB slots."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps, self.pps = sps, pps
        self.mb_w, self.mb_h = sps.pic_width_in_mbs, sps.pic_height_in_map_units
        sl4 = pps.scaling_lists_4x4 if pps.scaling_lists_4x4 is not None \
            else sps.scaling_lists_4x4
        sl8 = pps.scaling_lists_8x8 if pps.scaling_lists_8x8 is not None \
            else sps.scaling_lists_8x8
        ws4, ws8 = make_ws_consts(sl4, sl8)
        self._base = functools.partial(
            decode_frame_fn, mb_w=self.mb_w, mb_h=self.mb_h,
            ws4=jnp.asarray(ws4), ws8=jnp.asarray(ws8),
            cqp_off=(pps.chroma_qp_index_offset, pps.chroma_qp_offset(1)),
            bypass=bool(sps.qpprime_y_zero_transform_bypass_flag),
            field=not sps.frame_mbs_only_flag,
        )
        self._fns: dict = {}
        self._store = jax.jit(store_ref_fn, donate_argnums=(0, 1))
        # interlaced SPS: each reference FRAME is two field pictures, each
        # in its own (half-height) device slot (all-field PAFF decode)
        per_frame = 1 if sps.frame_mbs_only_flag else 2
        self.n_slots = max(2, min(sps.max_num_ref_frames * per_frame,
                                  32) + 1)
        self.dpb_y4p, self.dpb_cp = dpb_alloc(self.mb_w, self.mb_h,
                                              self.n_slots)

    def upload_abi(self, abi: FrameABI):
        """Host ABI -> dense device ABI via the compact wire format
        (ops.wire): ~44 MB/frame of mostly-zero int32 shrinks to well
        under 1 MB in ONE u8 buffer per frame; a small per-spec jitted
        scatter rebuilds the dense tensors device-side.  Opt out with
        ARROW_H264_WIRE=0 (direct dense upload)."""
        if os.environ.get("ARROW_H264_WIRE") == "0":
            return {k: jnp.asarray(abi[k]) for k in ABI_DEVICE_KEYS}
        from ..ops.wire import (
            emit_wire, merge_specs, pack_wire_raw, spec_class, unpack_fn,
        )
        raw, spec = pack_wire_raw(abi, self.mb_w, self.mb_h)
        # sticky spec PER CLASS: once a section class has appeared, keep
        # shipping it — the decode fn retraces per dict STRUCTURE (which
        # keys the zero-omitting unpack produces), so a flapping spec
        # would recompile the pipeline every time a coeff class
        # (dis)appears between frames.  Sticky presence bounds that to a
        # few growths; bucketing by spec_class keeps the I-frames' dense
        # schemes from poisoning every P/B frame's upload (ops.wire).
        cls = spec_class(spec)
        specs = getattr(self, "_specs", None)
        if specs is None:
            # seed from the cross-process spec cache so repeat runs jit
            # the same settled structures (persistent-compile-cache hits)
            from ..ops.wire import load_sticky_specs
            specs = self._specs = load_sticky_specs(self.mb_w, self.mb_h)
        if cls not in specs:
            specs[cls] = spec
            grew = True
        else:
            merged = merge_specs([specs[cls], spec])
            grew = merged != specs[cls]
            specs[cls] = merged
        if grew:
            from ..ops.wire import save_sticky_specs
            save_sticky_specs(self.mb_w, self.mb_h, {cls: specs[cls]})
        target = specs[cls]
        buf = emit_wire(raw, spec, target, self.mb_w * self.mb_h)
        return unpack_fn(self.mb_w, self.mb_h, target)(jnp.asarray(buf))

    def decode_frame(self, abi: FrameABI):
        mode, _slots, patch = select_inter_mode(abi, self.mb_w, self.mb_h)
        abi["patch"] = patch
        if "wp" in abi:
            # slice-row overflow fallback (ops.abi._fill_dense_weights):
            # dense per-cell weights, wire bypass (the wire's 4-bit slice
            # ids and per-row tables can't carry >15 distinct rows)
            dev = {k: jnp.asarray(abi[k]) for k in ABI_DEVICE_KEYS
                   if k not in ("wtab", "slogwd")}
            dev["wp"] = jnp.asarray(abi["wp"])
            dev["logwd"] = jnp.asarray(abi["logwd"])
        else:
            dev = self.upload_abi(abi)
        if "cvoff" in abi:
            dev["cvoff"] = jnp.asarray(abi["cvoff"])
        inter = mode != "none"
        if inter not in self._fns:
            self._fns[inter] = jax.jit(functools.wraps(decode_frame_fn)(
                functools.partial(self._base, inter=inter)))
        return self._fns[inter](dev, self.dpb_y4p, self.dpb_cp)

    def store_ref(self, slot: int, y, cb, cr) -> None:
        self.dpb_y4p, self.dpb_cp = self._store(
            self.dpb_y4p, self.dpb_cp, slot,
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
