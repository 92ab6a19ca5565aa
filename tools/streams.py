"""Conformance-stream synthesis helpers (test infrastructure).

Uses the system libx264 (via tools/h264ref.c) to create real H.264 bitstreams
in a zero-egress container, and the system libavcodec h264 decoder as the
JM-stand-in golden-YUV oracle (SURVEY.md §4).
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
H264REF = REPO / "tools" / "h264ref"


def ensure_h264ref() -> str:
    """Build the oracle CLI on demand (the binary is gitignored, so a
    fresh checkout — e.g. the driver's bench box — has only the .c).

    Compiles to a temp path and os.replace()s into place so an
    interrupted gcc never leaves a fresh-mtime partial binary that later
    calls would treat as up to date."""
    import os
    src = REPO / "tools" / "h264ref.c"
    if not H264REF.exists() or H264REF.stat().st_mtime < src.stat().st_mtime:
        tmp = H264REF.with_suffix(".build")
        subprocess.run(
            ["gcc", "-O2", "-o", str(tmp), str(src),
             "-lavcodec", "-lavutil"], check=True)
        os.replace(tmp, H264REF)
    return str(H264REF)


def make_content(width: int, height: int, n_frames: int, seed: int = 0,
                 motion: bool = True, noise: int = 12) -> np.ndarray:
    """Synthesize YUV420 content with gradients, texture, edges, and motion.

    Returns uint8 array of shape [n, h*w*3//2] (planar YUV420 per frame).
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    # persistent random texture the scene scrolls over (so P-frames find matches)
    bigtex = rng.integers(0, 256, (height * 2, width * 2), dtype=np.int64)
    frames = []
    for i in range(n_frames):
        dx, dy = (3 * i, 2 * i) if motion else (0, 0)
        y = (xx * 3 + yy * 2 + dx * 5) % 256
        tex = bigtex[dy:dy + height, dx:dx + width] if motion else bigtex[:height, :width]
        y = (y * 2 + tex) // 3
        # hard edges: moving square
        sx, sy = (37 + 4 * i) % max(1, width - 40), (23 + 3 * i) % max(1, height - 40)
        y[sy:sy + 32, sx:sx + 32] = 235
        y[sy + 8:sy + 24, sx + 8:sx + 24] = 16
        # per-frame noise so residuals are non-trivial (noise=12 is
        # adversarially dense under qp26; ~3 models clean camera content)
        if noise:
            y = np.clip(y + rng.integers(-noise, noise + 1, y.shape),
                        0, 255).astype(np.uint8)
        else:
            y = np.clip(y, 0, 255).astype(np.uint8)
        u = ((xx // 2 + dy) % 256)[::2, ::2].astype(np.uint8)
        v = ((yy // 2 + dx) % 256)[::2, ::2].astype(np.uint8)
        frames.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
    return np.stack(frames)


def encode(yuv: np.ndarray, width: int, height: int, out_path: str,
           opts: list[str], fps: int = 25) -> bytes:
    """Encode planar YUV420 frames to an Annex-B file via libx264."""
    n = yuv.shape[0]
    tmp = Path(out_path).with_suffix(".yuv.tmp")
    tmp.write_bytes(yuv.tobytes())
    try:
        subprocess.run(
            [ensure_h264ref(), "encode", str(tmp), f"{width}x{height}",
             str(n), str(fps), out_path, *opts],
            check=True, capture_output=True,
        )
    finally:
        tmp.unlink(missing_ok=True)
    return Path(out_path).read_bytes()


def golden_decode(stream_path: str) -> tuple[np.ndarray, int, int]:
    """Decode with the system libavcodec h264 decoder -> (frames, W, H).

    frames: uint8 [n, h*w*3//2] planar YUV420 in output order.
    """
    out = Path(stream_path).with_suffix(".golden.yuv.tmp")
    try:
        r = subprocess.run([ensure_h264ref(), "decode", stream_path, str(out)],
                           check=True, capture_output=True, text=True)
        n, w, h = map(int, r.stdout.split())
        data = np.frombuffer(out.read_bytes(), dtype=np.uint8)
    finally:
        out.unlink(missing_ok=True)
    fsz = w * h * 3 // 2
    assert data.size == n * fsz, (data.size, n, fsz)
    return data.reshape(n, fsz), w, h


# Canonical per-config x264 option sets (BASELINE.json configs 1-4).
X264_COMMON = "slices=1:threads=1:scenecut=0:rc-lookahead=0"

CONFIG_OPTS = {
    1: ["profile=baseline", "qp=26", "g=1", "bf=0", "refs=1",
        f"x264-params=cabac=0:{X264_COMMON}"],
    2: ["profile=baseline", "qp=26", "g=250", "bf=0", "refs=1", "keyint_min=250",
        f"x264-params=cabac=0:subme=6:{X264_COMMON}"],
    3: ["profile=main", "qp=26", "g=250", "bf=2", "refs=4", "keyint_min=250",
        f"x264-params=cabac=1:weightb=1:b-pyramid=0:{X264_COMMON}"],
    4: ["profile=high", "qp=26", "g=250", "bf=2", "refs=4", "keyint_min=250",
        f"x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:b-pyramid=0:{X264_COMMON}"],
    # FRExt lossless (qpprime_y_zero_transform_bypass): QP'=0 transform
    # bypass + intra DPCM + CABAC I_PCM MBs (x264 uses them freely at qp 0)
    "lossless": ["profile=high444", "qp=0", "g=250", "bf=2", "refs=2",
                 "keyint_min=250",
                 f"x264-params=cabac=1:8x8dct=1:b-pyramid=0:{X264_COMMON}"],
}
