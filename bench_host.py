"""Host entropy throughput: the FULL per-lane host pipeline, fps per core.

Prints ONE JSON line.  This is the host half of the decode pipeline
(SURVEY.md §7 "CABAC throughput on host"): at N streams x F fps of device
throughput, the host must parse N*F frames/sec across its cores.

What is measured per frame (exactly BatchDecoder's per-lane work):
C++ slice parse -> ABI pack -> MC-mode selection -> wire pack/flatten ->
DPB commit bookkeeping.  `gil_hold_pct` is MEASURED, not asserted: ctypes
releases the GIL around every foreign call, so the time inside the C++
library (centropy.gil_meter) is the fraction that scales across host
threads; the rest serializes.  `projected_fps_at_8_cores` applies the
measured split: min(8 * fps_core, 1 / gil_held_seconds_per_frame).
"""

import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")   # no device work here


def main() -> None:
    from tools import streams
    from arrow_h264_tpu.api import Decoder
    from arrow_h264_tpu.host.centropy import gil_meter
    from arrow_h264_tpu.models.pipeline import select_inter_mode
    from arrow_h264_tpu.ops.wire import (
        emit_wire, merge_specs, pack_wire_raw, spec_class,
    )

    import numpy as np

    w, h = 1920, 1088
    zero = (np.zeros((h, w), np.uint8),
            np.zeros((h // 2, w // 2), np.uint8),
            np.zeros((h // 2, w // 2), np.uint8))

    def run(path, make):
        if not os.path.exists(path):
            make(path)
        data = open(path, "rb").read()
        dec = Decoder(entropy="cpp")
        assert dec.entropy == "cpp", "C++ entropy lib unavailable"
        gen = dec.parse_pictures(data)
        gil_meter.enabled = True
        gil_meter.reset()
        spec_sticky: dict = {}
        t0 = time.perf_counter()
        n = 0
        for pic, poc in gen:
            mb_w = pic.sps.pic_width_in_mbs
            mb_h = pic.sps.pic_height_in_map_units
            abi = dec.pack_abi(pic, poc)
            mode, sl, patch = select_inter_mode(abi, mb_w, mb_h)
            abi["patch"] = patch
            raw, spec = pack_wire_raw(abi, mb_w, mb_h)
            cls = spec_class(spec)
            spec_sticky[cls] = spec if cls not in spec_sticky \
                else merge_specs([spec_sticky[cls], spec])
            emit_wire(raw, spec, spec_sticky[cls], mb_w * mb_h)
            list(dec.commit(pic, poc, *zero, 4, lambda *a: None))
            n += 1
        dt = time.perf_counter() - t0
        gil_meter.enabled = False
        released = gil_meter.released_s
        kbit = len(data) * 8 / n / 1000
        fps = n / dt
        gil_held_per_frame = max(1e-9, (dt - released) / n)
        projected8 = min(8 * fps, 1.0 / gil_held_per_frame)
        return fps, kbit, 100.0 * (dt - released) / dt, projected8

    bench_dir = Path(__file__).resolve().parent / ".bench"
    bench_dir.mkdir(exist_ok=True)
    # adversarial: noise=12 under qp26 High/CABAC (~4 Mbit/frame) — the
    # worst-case bin density; broadcast: noise=3 qp30 (~1 Mbit/frame),
    # the content class bench.py's end-to-end line decodes
    adv_fps, adv_kbit, adv_gil, adv_p8 = run(
        str(bench_dir / "host_1080p.264"),
        lambda p: streams.encode(streams.make_content(w, h, 8, seed=7),
                                 w, h, p, streams.CONFIG_OPTS[4]))
    bro_fps, bro_kbit, bro_gil, bro_p8 = run(
        str(bench_dir / "host_1080p_broadcast.264"),
        lambda p: streams.encode(
            streams.make_content(w, h, 16, seed=100, noise=3), w, h, p,
            ["profile=high", "qp=30", "g=250", "bf=2", "refs=4",
             "keyint_min=250",
             "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:"
             "b-pyramid=0:" + streams.X264_COMMON]))
    cores = multiprocessing.cpu_count()
    print(json.dumps({
        "metric": "1080p High/CABAC host pipeline frames/sec/core "
                  "(parse + ABI + mode select + wire pack + commit)",
        "value": round(bro_fps, 2),
        "unit": "frames/sec/core",
        "content_kbit_per_frame": round(bro_kbit, 1),
        "gil_hold_pct": round(bro_gil, 1),
        "projected_fps_at_8_cores": round(bro_p8, 1),
        "adversarial_fps_core": round(adv_fps, 2),
        "adversarial_kbit_per_frame": round(adv_kbit, 1),
        "adversarial_gil_hold_pct": round(adv_gil, 1),
        "adversarial_projected_fps_at_8_cores": round(adv_p8, 1),
        "host_cores": cores,
        "scaling": "projected_fps_at_8_cores = min(8*fps_core, "
                   "1/gil_held_s_per_frame); gil_hold measured via "
                   "centropy.gil_meter (ctypes releases the GIL around "
                   "every C++ call)",
    }))


if __name__ == "__main__":
    main()
