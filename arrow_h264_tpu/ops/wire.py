"""Compact host->device wire format for the frame ABI.

The dense MB-tensor ABI (ops.abi) is the device-side contract, but
shipping it over the host->device link costs ~44 MB/frame at 1080p —
almost all of it zeros.  The wire is (a) small and (b) a SINGLE buffer
per upload.  Broadcast-grade 1080p packs to ~0.5-1 MB/frame vs 44 MB
dense.  Whether it beats the dense upload over PCIe is not measured
yet.

Layout (all sections concatenated into ONE uint8 buffer, 8-byte
aligned; the spec fully determines every offset so the same walk runs
host-side at pack time and device-side inside the jitted unpack):

  meta6    [n, 6]  u8   kind, qp, slice_id, flags(tr8|avail|i16|chroma),
                        nz bitmask lo/hi
  slice8   [S, 6]  i8   per-slice: disable_idc, alpha_off, beta_off,
                        slogwd_y, slogwd_c (denormalized per-MB fields
                        re-normalized to the slice table they came from)
  intra    sparse rows of 40 ext bytes (i4/i8 modes + packed avail) for
                        MBs that carry any intra side-info
  inter    "base": per-MB cell-0 mv/refidx/refslot (16x16 & skip MBs are
                        ~90% of P content) + sparse full-grid rows for
                        sub-partitioned MBs; refid is NOT shipped — slot
                        equality is uid equality within a frame, so the
                        deblock bS test runs on refslot directly
  <coeff>  "bm8": per nonzero block idx i32 + significance bitmap u16 +
                        nonzero values packed int8 (measured: |level| <=
                        127 on qp>=26 content; falls back to dense16 /
                        dense int32 when levels or density overflow)
  pcm      sparse u8 rows (rare), wtab sparse non-identity rows

`pack_wire` (host: numpy + C scan helpers from cpp/entropy.cpp) returns
(sections, spec); `flatten_wire` produces the single upload buffer;
`unpack_fn(spec)` is the jitted device-side scatter back to the dense
ABI.  For lockstep batches `merge_specs` + `conform_sections` bring all
streams of a round onto one spec so a single sharded upload + vmapped
unpack serves the whole batch.

Reference parity: the reference class has no host->device link at all
(single-address-space C); this layer exists because the design splits
entropy (host) from reconstruction (device-resident pipeline) per
SURVEY.md §7 step 2.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from .abi import MAX_SLICES, identity_wtab

# (field, source key, grid cells per MB, values per cell)
_COEFF_FIELDS = (
    ("l4", "luma4", 16, 16),
    ("l8", "luma8", 4, 64),
    ("ca", "chroma_ac", 8, 16),
    ("ldc", "luma_dc", 1, 16),
    ("cdc", "chroma_dc", 1, 8),
)

_COEFF_SHAPES = {"l4": (16, 4, 4), "l8": (4, 8, 8), "ca": (2, 2, 2, 4, 4),
                 "ldc": (4, 4), "cdc": (2, 2, 2)}

_MIN_BUCKET = 32
_WTAB_COLS = 33 * 33 * 3 * 4
NX_FLAG = 64      # shipped-refslot flag: ref is a non-existing (gap)
                  # picture — refid must not collide with the real
                  # picture at the same device slot (fits int8; device
                  # DPB slots are < 64)


def _bucket(k: int, cap: int, lo: int = _MIN_BUCKET) -> int:
    """Next bucket >= k from the {2^i, 3*2^i} ladder (<=33% padding;
    coarse enough to keep the unpack-jit variant count small)."""
    b = lo
    while True:
        if b >= k:
            return min(b, cap)
        if (b + (b >> 1)) >= k:
            return min(b + (b >> 1), cap)
        b <<= 1


# ---------------------------------------------------------------------------
# layout: spec -> ordered (name, dtype, shape) section table
# ---------------------------------------------------------------------------

def _sections_of(spec, n: int):
    """Ordered section table for one frame's wire buffer."""
    out = [("meta6", np.uint8, (n, 6)),
           ("slice8", np.int8, (MAX_SLICES, 6))]
    sd = dict((f, (s, b)) for f, s, b in spec)

    sch, b = sd["intra"]
    if sch == "sparse":
        out += [("in_idx", np.int32, (b,)), ("in_ext", np.uint8, (b, 40))]
    elif sch == "dense":
        out += [("in_ext", np.uint8, (n, 40))]

    sch, b = sd["inter"]
    if sch == "base":
        out += [("mv_base", np.int16, (n, 4)), ("ref_base", np.int8, (n, 4))]
        if b:
            out += [("nu_idx", np.int32, (b,)), ("nu_mv", np.int16, (b, 64)),
                    ("nu_ref", np.int8, (b, 64))]
    elif sch == "dense":
        out += [("mv16", np.int16, (n, 64)), ("ref8", np.int8, (n, 64))]

    for f, _, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        if sch == "bm8":
            br, bv = b
            bmw = (w + 15) // 16
            out += [(f + "_idx", np.int32, (br,)),
                    (f + "_bm", np.uint16, (br, bmw)),
                    (f + "_val", np.int8, (bv,))]
        elif sch == "dense16":
            out += [(f + "_dense", np.int16, (grid, w))]
        elif sch == "dense":
            out += [(f + "_dense", np.int32, (grid, w))]

    sch, b = sd["pcm"]
    if sch == "sparse":
        out += [("pcm_idx", np.int32, (b,)), ("pcm_val", np.uint8, (b, 384))]
    elif sch == "dense":
        out += [("pcm_val", np.uint8, (n, 384))]

    sch, b = sd["wtab"]
    if sch == "sparse":
        out += [("wt_idx", np.int32, (b,)),
                ("wt_val", np.int16, (b, _WTAB_COLS))]

    if "patch" in sd:                     # hybrid-MC repair cell list
        sch, b = sd["patch"]
        if sch == "sparse":
            out += [("pt_idx", np.int32, (b,))]
    return out


def _offsets(spec, n: int):
    """(name -> (offset, dtype, shape)) plus total buffer bytes."""
    off = 0
    table = {}
    for name, dt, shape in _sections_of(spec, n):
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        table[name] = (off, dt, shape)
        off += (nbytes + 7) & ~7
    return table, off


def flatten_wire(sections, spec, n: int) -> np.ndarray:
    """Sections dict -> ONE uint8 buffer (a single device_put per frame
    instead of one per key)."""
    table, total = _offsets(spec, n)
    buf = np.zeros(total, np.uint8)
    for name, (off, dt, shape) in table.items():
        a = np.ascontiguousarray(sections[name], dtype=dt)
        raw = a.view(np.uint8).reshape(-1)
        buf[off:off + raw.size] = raw
    return buf


# ---------------------------------------------------------------------------
# host pack
# ---------------------------------------------------------------------------

def _pack_meta(abi, n: int, sec: dict):
    m = np.empty((n, 6), np.uint8)
    m[:, 0] = abi["kind"]
    m[:, 1] = abi["qp"]
    # slice_id < MAX_SLICES = 16 occupies bits 0..3; bit 4 carries the
    # per-MB deblock-disable override (concealment edges), which the
    # per-slice renormalization of disable_idc below would otherwise drop
    dbo = np.asarray(abi.get("deblock_off", 0), np.uint8)
    m[:, 2] = np.asarray(abi["slice_id"], np.uint8) | (dbo << 4)
    mba = np.asarray(abi["mb_avail"], np.uint8)
    m[:, 3] = (np.asarray(abi["tr8"], np.uint8)
               | (mba[:, 0] << 1) | (mba[:, 1] << 2) | (mba[:, 2] << 3)
               | (np.asarray(abi["i16_mode"], np.uint8) << 4)
               | (np.asarray(abi["chroma_mode"], np.uint8) << 6))
    nzb = np.packbits(np.asarray(abi["nz"], np.uint8).reshape(n, 16),
                      axis=1, bitorder="little")
    m[:, 4:6] = nzb
    sec["meta6"] = m

    tab = np.zeros((MAX_SLICES, 6), np.int8)
    sid = np.asarray(abi["slice_id"])
    # MBs carrying the per-MB override (concealment wrote disable_idc=1
    # for the dense path) must not pollute their slice's row: scatter
    # only from clean MBs (all MBs of a slice share the header values,
    # so any clean member fills the row correctly)
    clean = np.broadcast_to(np.asarray(dbo == 0), sid.shape)
    tab[sid[clean], 0] = np.asarray(abi["disable_idc"], np.int8)[clean]
    tab[sid, 1] = np.asarray(abi["alpha_off"], np.int8)
    tab[sid, 2] = np.asarray(abi["beta_off"], np.int8)
    tab[:, 3:5] = np.asarray(abi["slogwd"], np.int8)
    sec["slice8"] = tab


def _pack_intra(abi, n: int, sec: dict):
    # candidate rows first: the ext assembly (packbits over [n,16,4]) is
    # ~9 ms/frame at 1080p if run over the whole grid, but only MBs that
    # carry any intra side-info produce a nonzero row — build ext just
    # for those (P/B frames: a handful; I frames: everything, same cost)
    i4m = np.asarray(abi["i4_modes"])
    i4a = np.asarray(abi["i4_avail"])
    i8m = np.asarray(abi["i8_modes"])
    i8a = np.asarray(abi["i8_avail"])
    cand = (i4m.any(axis=1) | i4a.reshape(n, -1).any(axis=1)
            | i8m.any(axis=1) | i8a.reshape(n, -1).any(axis=1))
    rows = np.nonzero(cand)[0]
    k = len(rows)
    if k == 0:
        return ("intra", "zero", 0)

    def build_ext(sel):
        m = n if isinstance(sel, slice) else len(sel)
        ext = np.empty((m, 40), np.uint8)
        ext[:, 0:16] = i4m[sel]
        ext[:, 16:32] = np.packbits(
            i4a[sel].astype(np.uint8), axis=2,
            bitorder="little").reshape(m, 16)
        ext[:, 32:36] = i8m[sel]
        ext[:, 36:40] = np.packbits(
            i8a[sel].astype(np.uint8), axis=2,
            bitorder="little").reshape(m, 4)
        return ext

    b = _bucket(k, n)
    if b >= n:
        sec["in_ext"] = build_ext(slice(None))
        return ("intra", "dense", 0)
    idx = np.full(b, n, np.int32)
    idx[:k] = rows
    vals = np.zeros((b, 40), np.uint8)
    vals[:k] = build_ext(rows)
    sec["in_idx"] = idx
    sec["in_ext"] = vals
    return ("intra", "sparse", b)


def _pack_inter(abi, n: int, sec: dict, scan_inter):
    from .abi import KIND_P
    if not (np.asarray(abi["kind"]) >= KIND_P).any():
        return ("inter", "zero", 0)
    mv = np.ascontiguousarray(abi["mv"], np.int32)
    ridx = np.ascontiguousarray(abi["refidx"], np.int32)
    rslot = np.ascontiguousarray(abi["refslot"], np.int32)
    nx = abi.get("nx_uids")
    if nx is not None and len(nx):
        # cells referencing non-existing (frame_num-gap) pictures: flag
        # the shipped slot so unpack's refid:=refslot substitution keeps
        # them distinct from the real picture sharing device slot 0
        # (abi.note_nonexisting_refs); unpack strips the flag for MC
        rslot = np.where(np.isin(np.asarray(abi["refid"]), nx),
                         rslot | NX_FLAG, rslot)
    cap = n // 2 + 1
    if scan_inter is not None:
        k, mv_base, ref_base, idx_buf, mv_nu, ref_nu = \
            scan_inter(mv.reshape(n, 64), ridx.reshape(n, 32),
                       rslot.reshape(n, 32), cap)
    else:
        mvr = mv.reshape(n, 16, 4)
        rir = ridx.reshape(n, 16, 2)
        rsr = rslot.reshape(n, 16, 2)
        uni = ((mvr == mvr[:, :1]).all((1, 2))
               & (rir == rir[:, :1]).all((1, 2))
               & (rsr == rsr[:, :1]).all((1, 2)))
        rows = np.nonzero(~uni)[0]
        k = len(rows)
        mv_base = mvr[:, 0].astype(np.int16)
        ref_base = np.concatenate(
            [rir[:, 0], rsr[:, 0]], axis=1).astype(np.int8)
        idx_buf = rows
        mv_nu = mvr[rows[:cap]].reshape(-1, 64).astype(np.int16)
        ref_nu = np.concatenate(
            [rir[rows[:cap]].reshape(-1, 32),
             rsr[rows[:cap]].reshape(-1, 32)], axis=1).astype(np.int8)
    if k >= cap:
        sec["mv16"] = mv.astype(np.int16).reshape(n, 64)
        r8 = np.empty((n, 64), np.int8)
        r8[:, :32] = ridx.reshape(n, 32)
        r8[:, 32:] = rslot.reshape(n, 32)
        sec["ref8"] = r8
        return ("inter", "dense", 0)
    sec["mv_base"] = mv_base
    sec["ref_base"] = ref_base
    if k == 0:
        return ("inter", "base", 0)
    b = _bucket(k, cap)
    idx = np.full(b, n, np.int32)
    idx[:k] = idx_buf[:k]
    nmv = np.zeros((b, 64), np.int16)
    nmv[:k] = mv_nu[:k]
    nref = np.zeros((b, 64), np.int8)
    nref[:k] = ref_nu[:k]
    sec["nu_idx"] = idx
    sec["nu_mv"] = nmv
    sec["nu_ref"] = nref
    return ("inter", "base", b)


# ---------------------------------------------------------------------------
# raw pack + direct emit (the shipped hot path): scans produce COMPACT
# records (k rows, no bucket padding), and emit_wire writes every section
# straight into the final upload buffer at its spec offset — one
# allocation, one copy per section, conforming to a bigger target spec
# for free (pad space is just buffer zeros + idx sentinels).  The
# sections-dict API below (pack_wire/conform_sections/flatten_wire)
# remains as the readable reference implementation; emit_wire is
# differential-tested byte-equal against it (tests/test_wire.py).
# ---------------------------------------------------------------------------

def pack_wire_raw(abi, mb_w: int, mb_h: int):
    """Dense numpy ABI -> (raw records dict, own spec tuple).

    raw["<field>"] holds compact scan outputs (first-k rows only);
    emit_wire(raw, target, n) renders the single upload buffer."""
    n = mb_w * mb_h
    raw: dict = {}
    spec = []
    sec: dict = {}
    _pack_meta(abi, n, sec)
    raw["meta6"] = sec["meta6"]
    raw["slice8"] = sec["slice8"]

    # intra (same candidate logic as _pack_intra, kept compact)
    i4m = np.asarray(abi["i4_modes"])
    i4a = np.asarray(abi["i4_avail"])
    i8m = np.asarray(abi["i8_modes"])
    i8a = np.asarray(abi["i8_avail"])
    cand = (i4m.any(axis=1) | i4a.reshape(n, -1).any(axis=1)
            | i8m.any(axis=1) | i8a.reshape(n, -1).any(axis=1))
    rows = np.nonzero(cand)[0]
    k = len(rows)
    if k == 0:
        spec.append(("intra", "zero", 0))
    else:
        sel = slice(None) if _bucket(k, n) >= n else rows
        m = n if isinstance(sel, slice) else k
        ext = np.empty((m, 40), np.uint8)
        ext[:, 0:16] = i4m[sel]
        ext[:, 16:32] = np.packbits(i4a[sel].astype(np.uint8), axis=2,
                                    bitorder="little").reshape(m, 16)
        ext[:, 32:36] = i8m[sel]
        ext[:, 36:40] = np.packbits(i8a[sel].astype(np.uint8), axis=2,
                                    bitorder="little").reshape(m, 4)
        if m == n:
            spec.append(("intra", "dense", 0))
            raw["in_ext"] = ext
        else:
            spec.append(("intra", "sparse", _bucket(k, n)))
            raw["in_idx"] = rows.astype(np.int32)
            raw["in_ext"] = ext

    # inter
    from .abi import KIND_P
    if not (np.asarray(abi["kind"]) >= KIND_P).any():
        spec.append(("inter", "zero", 0))
    else:
        mv = np.ascontiguousarray(abi["mv"], np.int32)
        ridx = np.ascontiguousarray(abi["refidx"], np.int32)
        rslot = np.ascontiguousarray(abi["refslot"], np.int32)
        nx = abi.get("nx_uids")
        if nx is not None and len(nx):
            rslot = np.where(np.isin(np.asarray(abi["refid"]), nx),
                             rslot | NX_FLAG, rslot)
        cap = n // 2 + 1
        try:
            from ..host.centropy import scan_inter
        except Exception:
            scan_inter = None
        if scan_inter is not None:
            k, mv_base, ref_base, idx_buf, mv_nu, ref_nu = \
                scan_inter(mv.reshape(n, 64), ridx.reshape(n, 32),
                           rslot.reshape(n, 32), cap)
        else:
            mvr = mv.reshape(n, 16, 4)
            rir = ridx.reshape(n, 16, 2)
            rsr = rslot.reshape(n, 16, 2)
            uni = ((mvr == mvr[:, :1]).all((1, 2))
                   & (rir == rir[:, :1]).all((1, 2))
                   & (rsr == rsr[:, :1]).all((1, 2)))
            idx_buf = np.nonzero(~uni)[0]
            k = len(idx_buf)
            mv_base = mvr[:, 0].astype(np.int16)
            ref_base = np.concatenate(
                [rir[:, 0], rsr[:, 0]], axis=1).astype(np.int8)
            mv_nu = mvr[idx_buf[:cap]].reshape(-1, 64).astype(np.int16)
            ref_nu = np.concatenate(
                [rir[idx_buf[:cap]].reshape(-1, 32),
                 rsr[idx_buf[:cap]].reshape(-1, 32)], axis=1) \
                .astype(np.int8)
        if k >= cap:
            spec.append(("inter", "dense", 0))
            raw["mv16"] = mv.reshape(n, 64)
            raw["ref8_idx"] = ridx.reshape(n, 32)
            raw["ref8_slot"] = rslot.reshape(n, 32)
        else:
            spec.append(("inter", "base",
                         _bucket(k, cap) if k else 0))
            raw["mv_base"] = mv_base
            raw["ref_base"] = ref_base
            if k:
                raw["nu_idx"] = np.asarray(idx_buf[:k], np.int32)
                raw["nu_mv"] = mv_nu[:k]
                raw["nu_ref"] = ref_nu[:k]
            raw["nu_k"] = k

    try:
        from ..host.centropy import gather_blocks8, scan_blocks8
    except Exception:
        scan_blocks8 = gather_blocks8 = None
    nzr = abi.get("_nzr")
    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        src = np.ascontiguousarray(abi[key], np.int32).reshape(grid, w)
        cap_r = grid // 2 + 1
        cap_v = grid * w // 4 + 1
        res = None
        if nzr is not None and gather_blocks8 is not None and f in nzr:
            # decode-time row hints: touch only recorded rows (falls
            # back to the full scan on unsorted hints, e.g. ASO)
            res = gather_blocks8(src, np.ascontiguousarray(
                nzr[f], np.int32), cap_r, cap_v)
        if res is not None:
            k, idx_buf, bm_buf, val_buf, nnz, ovf = res
        elif scan_blocks8 is not None:
            k, idx_buf, bm_buf, val_buf, nnz, ovf = \
                scan_blocks8(src, cap_r, cap_v)
        else:
            mask = src != 0
            rows = np.nonzero(mask.any(axis=1))[0]
            k = len(rows)
            idx_buf = rows
            sel = mask[rows[:cap_r]]
            bmw = (w + 15) // 16
            padded = np.zeros((sel.shape[0], bmw * 16), np.uint16)
            padded[:, :w] = sel
            bm_buf = (padded.reshape(-1, bmw, 16)
                      << np.arange(16, dtype=np.uint16)).sum(
                          axis=2, dtype=np.uint16)
            blocks = src[rows[:cap_r]]
            flat = blocks[sel]
            nnz = flat.size
            ovf = bool(nnz) and (flat.min() < -128 or flat.max() > 127
                                 or nnz > cap_v)
            val_buf = flat[:cap_v].astype(np.int8)
        if k == 0:
            spec.append((f, "zero", 0))
            continue
        if k >= cap_r or ovf:
            a16 = src.astype(np.int16)
            if np.array_equal(a16, src):
                spec.append((f, "dense16", 0))
                raw[f + "_src16"] = a16
            else:
                spec.append((f, "dense", 0))
                raw[f + "_src"] = src
            continue
        spec.append((f, "bm8", (_bucket(k, grid),
                                _bucket(nnz, grid * w, lo=128))))
        raw[f + "_idx"] = np.asarray(idx_buf[:k], np.int32)
        raw[f + "_bm"] = bm_buf[:k]
        raw[f + "_val"] = val_buf[:nnz]
        raw[f + "_nnz"] = nnz

    from .abi import KIND_IPCM
    kind = np.asarray(abi["kind"])
    rows = np.nonzero(kind == KIND_IPCM)[0]
    if len(rows) == 0:
        spec.append(("pcm", "zero", 0))
    else:
        src = np.asarray(abi["pcm"], np.uint8).reshape(n, 384)
        k = len(rows)
        b = _bucket(k, n, lo=1)
        if b >= n:
            spec.append(("pcm", "dense", 0))
            raw["pcm_val"] = src
        else:
            spec.append(("pcm", "sparse", b))
            raw["pcm_idx"] = rows.astype(np.int32)
            raw["pcm_val"] = src[rows]

    wt = np.asarray(abi["wtab"])
    ident = identity_wtab()
    rows = np.nonzero((wt != ident).any(axis=(1, 2, 3, 4)))[0]
    if len(rows) == 0:
        spec.append(("wtab", "zero", 0))
    else:
        k = len(rows)
        b = _bucket(k, MAX_SLICES, lo=1)
        spec.append(("wtab", "sparse", b))
        raw["wt_idx"] = rows[:b].astype(np.int32)
        raw["wt_val"] = wt[rows[:b]].reshape(-1, _WTAB_COLS) \
            .astype(np.int16)

    pt = abi.get("patch")
    k = 0 if pt is None else int((np.asarray(pt) >= 0).sum())
    if k == 0:
        spec.append(("patch", "zero", 0))
    else:
        pt = np.asarray(pt, np.int32)
        spec.append(("patch", "sparse", _bucket(k, len(pt))))
        raw["pt_idx"] = pt[:k]
    return raw, tuple(spec)


def emit_wire(raw, spec, target, n: int) -> np.ndarray:
    """Raw records (own `spec`) -> ONE uint8 buffer laid out per
    `target` (a superset spec from merge_specs, or spec itself).
    Byte-equal to flatten_wire(conform_sections(sections, spec, target))
    by construction (differential-tested)."""
    table, total = _offsets(target, n)
    buf = np.zeros(total, np.uint8)

    def view(name):
        off, dt, shape = table[name]
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        return buf[off:off + nbytes].view(dt).reshape(shape)

    view("meta6")[:] = raw["meta6"]
    view("slice8")[:] = raw["slice8"]
    sd = dict((f, (s, b)) for f, s, b in spec)
    td = dict((f, (s, b)) for f, s, b in target)

    sch, b = sd["intra"]
    tsch, tb = td["intra"]
    if tsch == "dense":
        if sch == "sparse":
            view("in_ext")[raw["in_idx"]] = raw["in_ext"]
        elif sch == "dense":
            view("in_ext")[:] = raw["in_ext"]
    elif tsch == "sparse":
        idx = view("in_idx")
        idx[:] = n
        if sch == "sparse":
            k = len(raw["in_idx"])
            idx[:k] = raw["in_idx"]
            view("in_ext")[:k] = raw["in_ext"]

    sch, b = sd["inter"]
    tsch, tb = td["inter"]
    if tsch == "dense":
        mv16 = view("mv16")
        ref8 = view("ref8")
        if sch == "dense":
            mv16[:] = raw["mv16"]
            ref8[:, :32] = raw["ref8_idx"]
            ref8[:, 32:] = raw["ref8_slot"]
        elif sch == "base":
            mv16[:] = np.tile(raw["mv_base"], 16)
            rb = raw["ref_base"]
            ref8[:, :32] = np.repeat(rb[:, 0:2], 16, axis=0) \
                .reshape(n, 32)
            ref8[:, 32:] = np.repeat(rb[:, 2:4], 16, axis=0) \
                .reshape(n, 32)
            if raw.get("nu_k"):
                k = raw["nu_k"]
                mv16[raw["nu_idx"]] = raw["nu_mv"]
                ref8[raw["nu_idx"]] = raw["nu_ref"]
        else:  # zero
            ref8[:] = -1
    elif tsch == "base":
        rbv = view("ref_base")
        if sch == "base":
            view("mv_base")[:] = raw["mv_base"]
            rbv[:] = raw["ref_base"]
        else:  # zero
            rbv[:] = -1
        if tb:
            idx = view("nu_idx")
            idx[:] = n
            if sch == "base" and raw.get("nu_k"):
                k = raw["nu_k"]
                idx[:k] = raw["nu_idx"]
                view("nu_mv")[:k] = raw["nu_mv"]
                view("nu_ref")[:k] = raw["nu_ref"]

    for f, _key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        tsch, tb = td[f]
        if tsch == "zero":
            continue
        if tsch in ("dense", "dense16"):
            dv = view(f + "_dense")
            if sch == "bm8":
                dv[:] = _expand_bm8_np(raw[f + "_idx"], raw[f + "_bm"],
                                       raw[f + "_val"], grid, w)
            elif sch in ("dense", "dense16"):
                dv[:] = raw.get(f + "_src16", raw.get(f + "_src"))
        else:  # bm8 target
            idx = view(f + "_idx")
            idx[:] = grid
            if sch == "bm8":
                k = len(raw[f + "_idx"])
                idx[:k] = raw[f + "_idx"]
                view(f + "_bm")[:k] = raw[f + "_bm"]
                view(f + "_val")[:raw[f + "_nnz"]] = raw[f + "_val"]

    sch, b = sd["pcm"]
    tsch, tb = td["pcm"]
    if tsch == "dense":
        if sch == "sparse":
            view("pcm_val")[raw["pcm_idx"]] = raw["pcm_val"]
        elif sch == "dense":
            view("pcm_val")[:] = raw["pcm_val"]
    elif tsch == "sparse":
        idx = view("pcm_idx")
        idx[:] = n
        if sch == "sparse":
            k = len(raw["pcm_idx"])
            idx[:k] = raw["pcm_idx"]
            view("pcm_val")[:k] = raw["pcm_val"]
        elif sch == "dense":
            # own dense cannot conform DOWN to sparse (merge_specs never
            # shrinks a scheme), so this case is unreachable
            raise AssertionError("pcm dense -> sparse")

    tsch, tb = td["wtab"]
    if tsch == "sparse":
        idx = view("wt_idx")
        idx[:] = MAX_SLICES
        if sd["wtab"][0] == "sparse":
            k = len(raw["wt_idx"])
            idx[:k] = raw["wt_idx"]
            view("wt_val")[:k] = raw["wt_val"]

    if "patch" in td:
        tsch, tb = td["patch"]
        if tsch == "sparse":
            idx = view("pt_idx")
            idx[:] = -1
            if sd["patch"][0] == "sparse":
                k = len(raw["pt_idx"])
                idx[:k] = raw["pt_idx"]
    return buf


def pack_wire(abi, mb_w: int, mb_h: int):
    """Host side: dense numpy ABI -> (sections dict, spec tuple)."""
    n = mb_w * mb_h
    sec = {}
    spec = []
    _pack_meta(abi, n, sec)
    spec.append(_pack_intra(abi, n, sec))

    try:
        from ..host.centropy import scan_blocks8, scan_inter
    except Exception:
        scan_blocks8 = scan_inter = None
    spec.append(_pack_inter(abi, n, sec, scan_inter))

    kind = np.asarray(abi["kind"])
    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        src = np.ascontiguousarray(abi[key], np.int32).reshape(grid, w)
        cap_r = grid // 2 + 1
        cap_v = grid * w // 4 + 1
        if scan_blocks8 is not None:
            k, idx_buf, bm_buf, val_buf, nnz, ovf = \
                scan_blocks8(src, cap_r, cap_v)
        else:
            mask = src != 0
            rows = np.nonzero(mask.any(axis=1))[0]
            k = len(rows)
            idx_buf = rows
            sel = mask[rows[:cap_r]]
            bmw = (w + 15) // 16
            padded = np.zeros((sel.shape[0], bmw * 16), np.uint16)
            padded[:, :w] = sel
            bm_buf = (padded.reshape(-1, bmw, 16)
                      << np.arange(16, dtype=np.uint16)).sum(
                          axis=2, dtype=np.uint16)
            blocks = src[rows[:cap_r]]
            flat = blocks[sel]
            nnz = flat.size
            ovf = bool(nnz) and (flat.min() < -128 or flat.max() > 127
                                 or nnz > cap_v)
            val_buf = flat[:cap_v].astype(np.int8)
        if k == 0:
            spec.append((f, "zero", 0))
            continue
        if k >= cap_r or ovf:
            a16 = src.astype(np.int16)
            if np.array_equal(a16, src):
                spec.append((f, "dense16", 0))
                sec[f + "_dense"] = a16
            else:
                spec.append((f, "dense", 0))
                sec[f + "_dense"] = src
            continue
        br = _bucket(k, grid)
        bv = _bucket(nnz, grid * w, lo=128)
        spec.append((f, "bm8", (br, bv)))
        idx = np.full(br, grid, np.int32)
        idx[:k] = idx_buf[:k]
        bmw = (w + 15) // 16
        bm = np.zeros((br, bmw), np.uint16)
        bm[:k] = bm_buf[:k]
        vals = np.zeros(bv, np.int8)
        vals[:nnz] = val_buf[:nnz]
        sec[f + "_idx"] = idx
        sec[f + "_bm"] = bm
        sec[f + "_val"] = vals

    from .abi import KIND_IPCM
    rows = np.nonzero(kind == KIND_IPCM)[0]
    if len(rows) == 0:
        spec.append(("pcm", "zero", 0))
    else:
        src = np.asarray(abi["pcm"], np.uint8).reshape(n, 384)
        k = len(rows)
        b = _bucket(k, n, lo=1)
        if b >= n:
            spec.append(("pcm", "dense", 0))
            sec["pcm_val"] = src
        else:
            spec.append(("pcm", "sparse", b))
            idx = np.full(b, n, np.int32)
            idx[:k] = rows
            vals = np.zeros((b, 384), np.uint8)
            vals[:k] = src[rows]
            sec["pcm_idx"] = idx
            sec["pcm_val"] = vals

    wt = np.asarray(abi["wtab"])
    ident = identity_wtab()
    rows = np.nonzero((wt != ident).any(axis=(1, 2, 3, 4)))[0]
    if len(rows) == 0:
        spec.append(("wtab", "zero", 0))
    else:
        k = len(rows)
        b = _bucket(k, MAX_SLICES, lo=1)
        spec.append(("wtab", "sparse", b))
        idx = np.full(b, MAX_SLICES, np.int32)
        idx[:k] = rows[:b]
        vals = np.zeros((b, _WTAB_COLS), np.int16)
        vals[:k] = wt[rows[:b]].reshape(-1, _WTAB_COLS)
        sec["wt_idx"] = idx
        sec["wt_val"] = vals

    pt = abi.get("patch")
    k = 0 if pt is None else int((np.asarray(pt) >= 0).sum())
    if k == 0:
        spec.append(("patch", "zero", 0))
    else:
        pt = np.asarray(pt, np.int32)
        b = _bucket(k, len(pt))
        idx = np.full(b, -1, np.int32)
        idx[:k] = pt[:k]
        sec["pt_idx"] = idx
        spec.append(("patch", "sparse", b))
    return sec, tuple(spec)


def wire_nbytes(sections) -> int:
    if isinstance(sections, np.ndarray):
        return sections.nbytes
    return sum(np.asarray(v).nbytes for v in sections.values())


# ---------------------------------------------------------------------------
# spec merge / conform (lockstep batches share one spec per round)
# ---------------------------------------------------------------------------

_ORDER = {"zero": 0, "sparse": 1, "base": 1, "bm8": 1, "dense16": 2,
          "dense": 3}


def _bucket_max(entries):
    """Componentwise max over int-or-tuple buckets."""
    bs = [e[2] for e in entries if _ORDER[e[1]] == 1]
    if not bs:
        return 0
    if isinstance(bs[0], tuple):
        return tuple(max(b[i] for b in bs) for i in range(len(bs[0])))
    return max(bs)


# dense-scheme section bytes per MB, per field (int16 dense; intra/inter/
# pcm fixed-width rows).  Used by spec_class to weigh how much a dense
# scheme actually costs on the wire.
_DENSE_BYTES_PER_MB = {"l4": 16 * 16 * 2, "l8": 4 * 64 * 2,
                       "ca": 8 * 16 * 2, "ldc": 16 * 2, "cdc": 8 * 2,
                       "intra": 40, "inter": 64 * 2 + 64, "pcm": 384}


_SPEC_FIELDS = ("intra", "inter", "l4", "l8", "ca", "ldc", "cdc",
                "pcm", "wtab", "patch")


def _spec_cache_path() -> str:
    from ..cache import SPEC_CACHE
    return str(SPEC_CACHE)


def load_sticky_specs(mb_w: int, mb_h: int) -> dict:
    """Persisted sticky wire specs for this geometry: {class -> spec}.

    The sticky-spec ratchet otherwise makes each fresh process walk its
    own SEQUENCE of growing specs, and every step is a new jitted
    unpack/decode structure — a fresh compile.  Persisting the settled
    spec per (geometry, class) makes repeat runs (and a timed pass after
    a warmup) start at the final structure, so the
    persistent XLA compile cache actually hits.  Malformed or
    out-of-date entries are ignored (the spec re-settles on its own)."""
    import json
    import os
    try:
        with open(_spec_cache_path()) as f:
            all_specs = json.load(f)
    except (OSError, ValueError):
        return {}
    out = {}
    for cls, spec in (all_specs.get(f"{mb_w}x{mb_h}") or {}).items():
        try:
            t = tuple(
                (f, s, tuple(b) if isinstance(b, list) else int(b))
                for f, s, b in spec)
        except (TypeError, ValueError):
            continue
        if tuple(f for f, _, _ in t) == _SPEC_FIELDS and \
                all(s in _ORDER for _, s, _ in t):
            out[cls] = t
    return out


def save_sticky_specs(mb_w: int, mb_h: int, specs: dict) -> None:
    """Merge {class -> spec} into the on-disk cache (atomic replace;
    best-effort — failures never affect the decode)."""
    import json
    import os
    import tempfile
    path = _spec_cache_path()
    try:
        try:
            with open(path) as f:
                all_specs = json.load(f)
        except (OSError, ValueError):
            all_specs = {}
        key = f"{mb_w}x{mb_h}"
        cur = all_specs.get(key) or {}
        for cls, spec in specs.items():
            prev = cur.get(cls)
            if prev is not None:
                try:
                    spec = merge_specs([
                        tuple((f, s, tuple(b) if isinstance(b, list)
                               else int(b)) for f, s, b in prev), spec])
                except Exception:
                    pass
            cur[cls] = [[f, s, list(b) if isinstance(b, tuple) else b]
                        for f, s, b in spec]
        all_specs[key] = cur
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as f:
            json.dump(all_specs, f)
        os.replace(tmp, path)
    except OSError:
        pass


def spec_class(spec) -> str:
    """Coarse bucket for sticky-spec growth: a frame whose own pack needed
    a BIG dense section (I-frames; the odd coefficient-heavy P frame)
    must not poison the sticky spec of the common sparse frames — once a
    big dense16 coefficient class enters a shared sticky spec, EVERY
    later frame ships multi-MB dense sections over the host->HBM link
    and pays a bm8->dense expansion on the host.  Small dense sections
    (chroma/luma DC at <=32 B/MB) are cheaper shipped dense than worth a
    second spec class.  One sticky spec per class bounds pipeline
    retraces to (a few growths) x 2 classes."""
    heavy = sum(_DENSE_BYTES_PER_MB.get(f, 0)
                for f, s, _ in spec if _ORDER[s] >= 2)
    return "dense" if heavy > 48 else "sparse"


def merge_specs(specs):
    """Superset spec: per field the max scheme / bucket across streams."""
    out = []
    for entries in zip(*specs):
        f = entries[0][0]
        assert all(e[0] == f for e in entries)
        scheme = max((e[1] for e in entries), key=_ORDER.__getitem__)
        out.append((f, scheme,
                    _bucket_max(entries) if _ORDER[scheme] == 1 else 0))
    return tuple(out)


def conform_sections(sec, spec, target, mb_w: int, mb_h: int):
    """Pad / densify a stream's sections up to the merged round spec."""
    if spec == target:
        return sec
    n = mb_w * mb_h
    out = dict(sec)
    for (f, sch, b), (_, tsch, tb) in zip(spec, target):
        if (sch, b) == (tsch, tb):
            continue
        if f == "intra":
            if tsch == "dense":
                ext = np.zeros((n, 40), np.uint8)
                if sch == "sparse":
                    idx = out.pop("in_idx")
                    vals = out.pop("in_ext")
                    live = idx < n
                    ext[idx[live]] = vals[live]
                elif sch == "dense":
                    ext = out["in_ext"]
                out["in_ext"] = ext
            else:  # sparse target
                idx = np.full(tb, n, np.int32)
                vals = np.zeros((tb, 40), np.uint8)
                if sch == "sparse":
                    idx[:b] = out.pop("in_idx")
                    vals[:b] = out.pop("in_ext")
                out["in_idx"] = idx
                out["in_ext"] = vals
        elif f == "inter":
            if tsch == "dense":
                if sch != "dense":
                    mv16 = np.zeros((n, 64), np.int16)
                    ref8 = np.full((n, 64), -1, np.int8)
                    if sch == "base":
                        mv16[:] = np.tile(out.pop("mv_base"), 16)
                        rb = out.pop("ref_base")
                        ref8[:, :32] = np.repeat(
                            rb[:, 0:2], 16, axis=0).reshape(n, 32)
                        ref8[:, 32:] = np.repeat(
                            rb[:, 2:4], 16, axis=0).reshape(n, 32)
                        if b:
                            idx = out.pop("nu_idx")
                            live = idx < n
                            mv16[idx[live]] = out.pop("nu_mv")[live]
                            ref8[idx[live]] = out.pop("nu_ref")[live]
                    out["mv16"] = mv16
                    out["ref8"] = ref8
            else:  # base target
                if sch == "zero":
                    out["mv_base"] = np.zeros((n, 4), np.int16)
                    out["ref_base"] = np.full((n, 4), -1, np.int8)
                if tb:
                    idx = np.full(tb, n, np.int32)
                    nmv = np.zeros((tb, 64), np.int16)
                    nref = np.zeros((tb, 64), np.int8)
                    if sch == "base" and b:
                        idx[:b] = out.pop("nu_idx")
                        nmv[:b] = out.pop("nu_mv")
                        nref[:b] = out.pop("nu_ref")
                    out["nu_idx"] = idx
                    out["nu_mv"] = nmv
                    out["nu_ref"] = nref
        elif f == "pcm":
            if tsch == "dense":
                dense = np.zeros((n, 384), np.uint8)
                if sch == "sparse":
                    idx = out.pop("pcm_idx")
                    live = idx < n
                    dense[idx[live]] = out["pcm_val"][live]
                elif sch == "dense":
                    dense = out["pcm_val"]
                out["pcm_val"] = dense
            else:
                idx = np.full(tb, n, np.int32)
                vals = np.zeros((tb, 384), np.uint8)
                if sch == "sparse":
                    idx[:b] = out.pop("pcm_idx")
                    vals[:b] = out["pcm_val"]
                out["pcm_idx"] = idx
                out["pcm_val"] = vals
        elif f == "wtab":
            idx = np.full(tb, MAX_SLICES, np.int32)
            vals = np.zeros((tb, _WTAB_COLS), np.int16)
            if sch == "sparse":
                idx[:b] = out.pop("wt_idx")
                vals[:b] = out.pop("wt_val")
            out["wt_idx"] = idx
            out["wt_val"] = vals
        elif f == "patch":
            idx = np.full(tb, -1, np.int32)
            if sch == "sparse":
                idx[:b] = out.pop("pt_idx")
            out["pt_idx"] = idx
        elif f in _COEFF_SHAPES:
            cpm, w = next((c, ww) for ff, _, c, ww in _COEFF_FIELDS
                          if ff == f)
            grid = n * cpm
            if tsch in ("dense", "dense16"):
                ddt = np.int16 if tsch == "dense16" else np.int32
                dense = np.zeros((grid, w), ddt)
                if sch == "bm8":
                    idx = out.pop(f + "_idx")
                    bm = out.pop(f + "_bm")
                    vals = out.pop(f + "_val")
                    dense = _expand_bm8_np(idx, bm, vals, grid, w) \
                        .astype(ddt)
                elif sch in ("dense", "dense16"):
                    dense = out[f + "_dense"].astype(ddt)
                out[f + "_dense"] = dense
            else:  # bm8 target: pad row/val buckets
                tbr, tbv = tb
                idx = np.full(tbr, grid, np.int32)
                bmw = (w + 15) // 16
                bm = np.zeros((tbr, bmw), np.uint16)
                vals = np.zeros(tbv, np.int8)
                if sch == "bm8":
                    br, bv = b
                    idx[:br] = out.pop(f + "_idx")
                    bm[:br] = out.pop(f + "_bm")
                    vals[:bv] = out.pop(f + "_val")
                out[f + "_idx"] = idx
                out[f + "_bm"] = bm
                out[f + "_val"] = vals
    return out


def _expand_bm8_np(idx, bm, vals, grid: int, w: int):
    """Host-side bm8 -> dense int32 (conform fallback path)."""
    br, bmw = bm.shape
    bits = (bm[:, :, None] >> np.arange(16, dtype=np.uint16)) & 1
    mask = bits.reshape(br, bmw * 16)[:, :w].astype(bool)
    dense = np.zeros((grid + 1, w), np.int32)
    rows = np.zeros((br, w), np.int32)
    rows[mask] = vals[:int(mask.sum())].astype(np.int32)
    dense[np.minimum(idx, grid)] = rows
    return dense[:grid]


# ---------------------------------------------------------------------------
# device-side unpack (jit per spec; vmap for batches)
# ---------------------------------------------------------------------------

def _read(buf, table, name):
    off, dt, shape = table[name]
    nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
    seg = jax.lax.slice(buf, (off,), (off + nbytes,))
    isz = np.dtype(dt).itemsize
    if isz == 1:
        x = jax.lax.bitcast_convert_type(seg, jnp.dtype(dt)) \
            if dt != np.uint8 else seg
    else:
        x = jax.lax.bitcast_convert_type(
            seg.reshape(-1, isz), jnp.dtype(dt))
    return x.reshape(shape)


def _scatter_bm8(idx, bm, vals, grid: int, w: int):
    br, bmw = bm.shape
    bits = (bm[:, :, None].astype(jnp.int32)
            >> jnp.arange(16, dtype=jnp.int32)) & 1
    mask = bits.reshape(br, bmw * 16)[:, :w]
    flat = mask.reshape(-1)
    pos = jnp.cumsum(flat) - 1
    bv = vals.shape[0]
    gathered = vals.astype(jnp.int32)[jnp.clip(pos, 0, bv - 1)] * flat
    rows = gathered.reshape(br, w)
    dense = jnp.zeros((grid + 1, w), jnp.int32)
    dense = dense.at[idx].set(rows)
    return dense[:grid]


def unpack_wire_frame(buf, *, mb_w: int, mb_h: int, spec):
    """Flat u8 wire buffer (device array) -> dense int32 ABI dict."""
    n = mb_w * mb_h
    table, _total = _offsets(spec, n)
    sd = dict((f, (s, b)) for f, s, b in spec)

    m = _read(buf, table, "meta6").astype(jnp.int32)
    fl = m[:, 3]
    tab = _read(buf, table, "slice8").astype(jnp.int32)
    sid = m[:, 2] & 15
    dbo = (m[:, 2] >> 4) & 1           # per-MB deblock-disable override
    nzm = m[:, 4] | (m[:, 5] << 8)
    out = {
        "kind": m[:, 0], "qp": m[:, 1], "slice_id": sid,
        "tr8": fl & 1,
        "mb_avail": jnp.stack([(fl >> b) & 1 for b in (1, 2, 3)], 1),
        "i16_mode": (fl >> 4) & 3, "chroma_mode": (fl >> 6) & 3,
        "disable_idc": jnp.where(dbo == 1, 1, tab[sid, 0]),
        "alpha_off": tab[sid, 1], "beta_off": tab[sid, 2],
        "slogwd": tab[:, 3:5],
        "nz": jnp.stack([(nzm >> b) & 1 for b in range(16)], 1)
            .reshape(n, 4, 4),
    }

    sch, b = sd["intra"]
    if sch == "zero":
        ext = jnp.zeros((n, 40), jnp.int32)
    elif sch == "dense":
        ext = _read(buf, table, "in_ext").astype(jnp.int32)
    else:
        idx = _read(buf, table, "in_idx")
        vals = _read(buf, table, "in_ext").astype(jnp.int32)
        ext = jnp.zeros((n + 1, 40), jnp.int32).at[idx].set(vals)[:n]
    out["i4_modes"] = ext[:, 0:16]
    out["i4_avail"] = jnp.stack(
        [(ext[:, 16:32] >> b) & 1 for b in range(4)], 2)
    out["i8_modes"] = ext[:, 32:36]
    out["i8_avail"] = jnp.stack(
        [(ext[:, 36:40] >> b) & 1 for b in range(4)], 2)

    sch, b = sd["inter"]
    if sch == "zero":
        out["mv"] = jnp.zeros((n, 4, 4, 2, 2), jnp.int32)
        out["refidx"] = jnp.full((n, 4, 4, 2), -1, jnp.int32)
        out["refslot"] = jnp.full((n, 4, 4, 2), -1, jnp.int32)
    elif sch == "dense":
        out["mv"] = _read(buf, table, "mv16").astype(jnp.int32) \
            .reshape(n, 4, 4, 2, 2)
        r8 = _read(buf, table, "ref8").astype(jnp.int32)
        out["refidx"] = r8[:, 0:32].reshape(n, 4, 4, 2)
        out["refslot"] = r8[:, 32:64].reshape(n, 4, 4, 2)
    else:
        mvb = _read(buf, table, "mv_base").astype(jnp.int32)
        rb = _read(buf, table, "ref_base").astype(jnp.int32)
        mv = jnp.tile(mvb, (1, 16))                      # [n, 64]
        ridx = jnp.tile(rb[:, 0:2], (1, 16))             # [n, 32]
        rslot = jnp.tile(rb[:, 2:4], (1, 16))
        if b:
            idx = _read(buf, table, "nu_idx")
            nmv = _read(buf, table, "nu_mv").astype(jnp.int32)
            nref = _read(buf, table, "nu_ref").astype(jnp.int32)
            mv = jnp.concatenate([mv, jnp.zeros((1, 64), jnp.int32)]) \
                .at[idx].set(nmv)[:n]
            ref = jnp.concatenate(
                [jnp.concatenate([ridx, rslot], 1),
                 jnp.zeros((1, 64), jnp.int32)]).at[idx].set(nref)[:n]
            ridx, rslot = ref[:, :32], ref[:, 32:]
        out["mv"] = mv.reshape(n, 4, 4, 2, 2)
        out["refidx"] = ridx.reshape(n, 4, 4, 2)
        out["refslot"] = rslot.reshape(n, 4, 4, 2)
    # refid is never shipped: within one frame the DPB slot identifies
    # the picture, and deblock's bS test only needs equality/validity —
    # both preserved by the injective uid -> slot substitution.  Cells
    # referencing non-existing (gap) pictures arrive with NX_FLAG set
    # (see _pack_inter): keep the flag in refid (distinct bS identity)
    # and strip it for the MC gather slot.
    rs = out["refslot"]
    out["refid"] = rs
    out["refslot"] = jnp.where(rs >= 0, rs & (NX_FLAG - 1), rs)

    keymap = dict((f, k) for f, k, _, _ in _COEFF_FIELDS)
    for f, key, cpm, w in _COEFF_FIELDS:
        grid = n * cpm
        sch, b = sd[f]
        shape = (n,) + _COEFF_SHAPES[f]
        if sch == "zero":
            # all-zero coeff tensors are OMITTED from the dict, not
            # materialized: ops.transforms.residual_planes skips the
            # corresponding dequant/IDCT path entirely (a zero luma8
            # alone is ~8 MB/frame of HBM writes + a full 8x8 IDCT)
            continue
        elif sch in ("dense", "dense16"):
            out[key] = _read(buf, table, f + "_dense").astype(jnp.int32) \
                .reshape(shape)
        else:
            dense = _scatter_bm8(
                _read(buf, table, f + "_idx"),
                _read(buf, table, f + "_bm"),
                _read(buf, table, f + "_val"), grid, w)
            out[key] = dense.reshape(shape)

    sch, b = sd["pcm"]
    if sch == "zero":
        pass                      # omitted, like zero coeff tensors
    elif sch == "dense":
        out["pcm"] = _read(buf, table, "pcm_val").astype(jnp.int32)
    else:
        idx = _read(buf, table, "pcm_idx")
        vals = _read(buf, table, "pcm_val").astype(jnp.int32)
        out["pcm"] = jnp.zeros((n + 1, 384), jnp.int32) \
            .at[idx].set(vals)[:n]

    sch, b = sd["wtab"]
    ident = jnp.asarray(identity_wtab())
    if sch == "zero":
        out["wtab"] = ident
    else:
        idx = _read(buf, table, "wt_idx")
        vals = _read(buf, table, "wt_val").astype(ident.dtype) \
            .reshape(-1, 33, 33, 3, 4)
        upd = jnp.concatenate(
            [ident, jnp.zeros((1,) + ident.shape[1:], ident.dtype)])
        out["wtab"] = upd.at[idx].set(vals)[:MAX_SLICES]
    out["slogwd"] = out["slogwd"].astype(jnp.int32)

    from .abi import patch_capacity
    K = patch_capacity(mb_w, mb_h)
    patch = jnp.full((K,), -1, jnp.int32)
    if "patch" in sd and sd["patch"][0] == "sparse":
        idx = _read(buf, table, "pt_idx")
        patch = patch.at[: idx.shape[0]].set(idx)
    out["patch"] = patch
    return out


@functools.lru_cache(maxsize=64)
def unpack_fn(mb_w: int, mb_h: int, spec, batched: bool = False):
    """jit-compiled unpack for one spec (optionally vmapped over B)."""
    f = functools.partial(unpack_wire_frame, mb_w=mb_w, mb_h=mb_h,
                          spec=spec)
    return jax.jit(jax.vmap(f) if batched else f)
