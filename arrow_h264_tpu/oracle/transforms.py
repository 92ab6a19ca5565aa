"""Spec-literal inverse transform + scaling oracle (numpy, spec 8.5).

Reference parity: JM-lineage `transform.c` / `block.c` / `quant.c`
(SURVEY.md §2; reference mount empty — implemented from spec 8.5.9-8.5.13).

This module is the bit-exact unit-test oracle for the JAX device path.
All math is integer; inputs/outputs are numpy int32 arrays.
"""

from __future__ import annotations

import numpy as np

from ..common.tables import NORM_ADJUST_4x4, NORM_ADJUST_8x8, ZIGZAG_4x4, ZIGZAG_8x8


def weight_scale_raster_4x4(weight_scale_zz) -> np.ndarray:
    ws = np.zeros((4, 4), np.int32)
    for k, pos in enumerate(ZIGZAG_4x4):
        ws[pos // 4, pos % 4] = weight_scale_zz[k]
    return ws


def weight_scale_raster_8x8(weight_scale_zz) -> np.ndarray:
    ws = np.zeros((8, 8), np.int32)
    for k, pos in enumerate(ZIGZAG_8x8):
        ws[pos // 8, pos % 8] = weight_scale_zz[k]
    return ws


def dequant4x4(c: np.ndarray, qp: int, weight_scale: np.ndarray,
               dc_passthrough: bool = False) -> np.ndarray:
    """Scaling of 4x4 residual blocks, spec 8.5.12.1.

    `c` raster [4,4] int; `weight_scale` raster [4,4] (flat list -> 16s).
    When `dc_passthrough`, d[0,0] = c[0,0] (Intra_16x16 luma AC / chroma AC:
    the DC was scaled by the separate DC transform path).
    """
    ls = weight_scale * NORM_ADJUST_4x4[qp % 6]
    if qp >= 24:
        d = (c * ls) << (qp // 6 - 4)
    else:
        d = (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)
    if dc_passthrough:
        d[0, 0] = c[0, 0]
    return d.astype(np.int64)


def idct4x4(d: np.ndarray) -> np.ndarray:
    """4x4 inverse core transform, spec 8.5.12.2. Output = (h + 32) >> 6."""
    d = d.astype(np.int64)

    def rows(m):
        e0 = m[:, 0] + m[:, 2]
        e1 = m[:, 0] - m[:, 2]
        e2 = (m[:, 1] >> 1) - m[:, 3]
        e3 = m[:, 1] + (m[:, 3] >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)

    f = rows(d)
    h = rows(f.T).T  # same butterfly on columns
    return (h + 32) >> 6


def luma_dc_dequant(c: np.ndarray, qp: int, weight_scale_00: int) -> np.ndarray:
    """Intra_16x16 luma DC: 4x4 Hadamard + scaling, spec 8.5.10."""
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
                 np.int64)
    f = H @ c.astype(np.int64) @ H
    ls = int(weight_scale_00) * int(NORM_ADJUST_4x4[qp % 6, 0, 0])
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc_dequant(c: np.ndarray, qp: int, weight_scale_00: int) -> np.ndarray:
    """2x2 chroma DC transform + scaling (4:2:0), spec 8.5.11."""
    H = np.array([[1, 1], [1, -1]], np.int64)
    f = H @ c.astype(np.int64) @ H
    ls = int(weight_scale_00) * int(NORM_ADJUST_4x4[qp % 6, 0, 0])
    return ((f * ls) << (qp // 6)) >> 5


def dequant8x8(c: np.ndarray, qp: int, weight_scale: np.ndarray) -> np.ndarray:
    """Scaling of 8x8 residual blocks, spec 8.5.13.1."""
    ls = weight_scale * NORM_ADJUST_8x8[qp % 6]
    if qp >= 36:
        d = (c * ls) << (qp // 6 - 6)
    else:
        d = (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
    return d.astype(np.int64)


def idct8x8(d: np.ndarray) -> np.ndarray:
    """8x8 inverse transform, spec 8.5.13.2. Output = (k + 32) >> 6."""
    d = d.astype(np.int64)

    def stage(m):
        # m: [..., 8] operate along last axis
        d0, d1, d2, d3, d4, d5, d6, d7 = (m[..., i] for i in range(8))
        e0 = d0 + d4
        e1 = -d3 + d5 - d7 - (d7 >> 1)
        e2 = d0 - d4
        e3 = d1 + d7 - d3 - (d3 >> 1)
        e4 = (d2 >> 1) - d6
        e5 = -d1 + d7 + d5 + (d5 >> 1)
        e6 = d2 + (d6 >> 1)
        e7 = d3 + d5 + d1 + (d1 >> 1)
        f0 = e0 + e6
        f1 = e1 + (e7 >> 2)
        f2 = e2 + e4
        f3 = e3 + (e5 >> 2)
        f4 = e2 - e4
        f5 = (e3 >> 2) - e5
        f6 = e0 - e6
        f7 = e7 - (e1 >> 2)
        return np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                         f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)

    f = stage(d)            # horizontal (rows)
    k = stage(np.moveaxis(f, -1, -2))
    k = np.moveaxis(k, -1, -2)
    return (k + 32) >> 6


def inverse_scan_4x4(levels16: np.ndarray) -> np.ndarray:
    """Scan-order 16-vector -> raster 4x4 (spec 8.5.6)."""
    out = np.zeros(16, levels16.dtype)
    out[ZIGZAG_4x4] = levels16
    return out.reshape(4, 4)


def inverse_scan_8x8(levels64: np.ndarray) -> np.ndarray:
    out = np.zeros(64, levels64.dtype)
    out[ZIGZAG_8x8] = levels64
    return out.reshape(8, 8)
