"""The committed smoke streams and their per-frame golden hashes.

`smoke/` holds small Annex-B streams for conformance configs 1-4 and two
1080p sources for the 32-lane batch of chip_smoke.py, plus
`smoke/hashes.json`: the SHA-1 of every frame of the libavcodec golden
decode (planar YUV 4:2:0, output order).  They are committed because the
machine that runs chip_smoke.py need not have libx264 or libavcodec.

Regenerate them (needs libx264 and libavcodec for tools/h264ref):

    python tools/make_smoke_streams.py
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SMOKE_DIR = REPO / "smoke"
HASHES = SMOKE_DIR / "hashes.json"

# x264 settings of the batched 1080p bench content (bench.py make_streams)
_BENCH_1080P = ["profile=high", "qp=30", "g=250", "bf=2", "refs=4",
                "keyint_min=250",
                "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:"
                "b-pyramid=0:slices=1:threads=1:scenecut=0:rc-lookahead=0"]


def _config_opts(cfg: int, extra: str = "", qp: int | None = None
                 ) -> list[str]:
    from tools.streams import CONFIG_OPTS
    opts = list(CONFIG_OPTS[cfg])
    if qp is not None:
        opts = [f"qp={qp}" if o.startswith("qp=") else o for o in opts]
    if extra:
        opts[-1] = opts[-1] + ":" + extra
    return opts


# name -> (width, height, frames, content seed, content noise, x264 opts)
SPECS = {
    # 1: Baseline CAVLC, I-only
    "c1_qcif": (176, 144, 3, 41, 12, lambda: _config_opts(1)),
    # 2: Baseline CAVLC, P frames
    "c2_cif": (352, 288, 5, 42, 12, lambda: _config_opts(2)),
    # 3: Main CABAC, B frames, 4 references
    # (configs 3 and 4 at qp 32 keep the committed set small)
    "c3_720p": (1280, 720, 4, 43, 3, lambda: _config_opts(3, qp=32)),
    # 4: High, 8x8 transform, weighted prediction, JVT scaling matrices
    "c4_1080p": (1920, 1080, 3, 44, 3,
                 lambda: _config_opts(4, "cqm=jvt", qp=32)),
    # 32-lane batch sources: the bench's 1080p High/CABAC settings
    "lane_1080p_a": (1920, 1080, 8, 100, 3, lambda: list(_BENCH_1080P)),
    "lane_1080p_b": (1920, 1080, 8, 101, 3, lambda: list(_BENCH_1080P)),
}


def frame_hash(planar: bytes) -> str:
    return hashlib.sha1(planar).hexdigest()


def load(name: str) -> tuple[bytes, list[str]]:
    """(stream bytes, per-frame golden hashes) of one committed stream."""
    hashes = json.loads(HASHES.read_text())[name]["frames"]
    return (SMOKE_DIR / f"{name}.264").read_bytes(), hashes


def main() -> int:
    sys.path.insert(0, str(REPO))
    from tools import streams
    SMOKE_DIR.mkdir(exist_ok=True)
    table = {}
    for name, (w, h, n, seed, noise, opts) in SPECS.items():
        path = SMOKE_DIR / f"{name}.264"
        yuv = streams.make_content(w, h, n, seed=seed, noise=noise)
        streams.encode(yuv, w, h, str(path), opts())
        golden, gw, gh = streams.golden_decode(str(path))
        assert (gw, gh) == (w, h) and len(golden) == n, (name, gw, gh)
        table[name] = {"width": w, "height": h,
                       "frames": [frame_hash(f.tobytes()) for f in golden]}
        print(f"{name}: {w}x{h} {n} frames, {path.stat().st_size} bytes")
    HASHES.write_text(json.dumps(table, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
