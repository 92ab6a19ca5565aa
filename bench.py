"""Benchmark: END-TO-END batched 1080p decode throughput on one device.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...}.

The headline measures decoded frames per second through
`parallel.batch.BatchDecoder` on real x264-encoded 1080p High/CABAC
streams: host C++ entropy parse -> ABI upload -> sharded batched
reconstruction (gather MC, intra and deblock wavefronts) -> reference
store -> output emission, wall-clocked end-to-end with every output
frame materialized on the host.

Extra JSON fields report the parts separately:
  e2e_device_resident_fps — the same decode with outputs kept on the
                      device (BatchDecoder(materialize=False)).
  device_recon_fps  — device-only reconstruction throughput on synthetic
                      1080p P-frame ABIs at batch=32.
  device_intra_fps  — the same for all-intra ABIs.
  host_parse_fps    — the host entropy side alone for the same streams.
  d2h_GBps          — one device->host copy of a round's luma planes.

Each stage runs in its own subprocess, one after another, so exactly
one process holds the device at a time; this parent process never
initializes a JAX backend.  A failed stage makes the bench exit 1.

Content: tools/streams.make_content at noise=3, High profile qp=30,
bf=2 refs=4 (needs libx264 and libavcodec for tools/h264ref).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

W, H = 1920, 1088
N_SRC = 4            # distinct encoded streams
N_FRAMES = 12        # frames per stream
BATCH = 32           # concurrent lanes (each source used BATCH//N_SRC times)
STREAM_DIR = ROOT / ".bench"


def make_streams():
    from tools import streams
    STREAM_DIR.mkdir(exist_ok=True)
    paths = []
    for s in range(N_SRC):
        path = STREAM_DIR / f"e2e_1080p_s{s}_f{N_FRAMES}.264"
        if not path.exists():
            yuv = streams.make_content(W, H, N_FRAMES, seed=100 + s, noise=3)
            opts = ["profile=high", "qp=30", "g=250", "bf=2", "refs=4",
                    "keyint_min=250",
                    "x264-params=cabac=1:8x8dct=1:weightp=2:weightb=1:"
                    "b-pyramid=0:" + streams.X264_COMMON]
            streams.encode(yuv, W, H, str(path), opts)
        paths.append(path)
    return [p.read_bytes() for p in paths]


def _truncate_aus(data: bytes, k: int) -> bytes:
    """First k access units (single-slice streams): parameter sets plus
    the first k VCL NALs — a short warmup prefix that still touches
    every pipeline program (I round, P rounds, B rounds)."""
    from arrow_h264_tpu.bitstream.nal import split_annexb
    out, vcl = [], 0
    for ebsp in split_annexb(data):          # payloads, header byte first
        t = ebsp[0] & 0x1F
        if t in (1, 5):
            vcl += 1
            if vcl > k:
                break
        out.append(b"\x00\x00\x00\x01" + ebsp)
    return b"".join(out)


def _device_seconds(fn, *args, n: int = 5) -> float:
    """Seconds per call of jitted fn(*args), compile excluded."""
    import jax
    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jf(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def bench_e2e(datas):
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    lanes = [datas[i % N_SRC] for i in range(BATCH)]
    # warmup/compile pass: a short prefix per lane (same geometry and
    # program sequence; the persisted sticky specs keep the jitted
    # structures identical to the full run)
    warm_lanes = [_truncate_aus(d, 6) for d in lanes]
    bd = BatchDecoder(n_streams=BATCH)
    t0 = time.perf_counter()
    frames = bd.decode(warm_lanes)
    warm_s = time.perf_counter() - t0
    n = sum(len(f) for f in frames)
    errs = [e for e in bd.errors if e is not None]
    assert not errs, errs[:2]
    assert n == BATCH * 6, (n, BATCH)
    # free the warmup decoder's batched DPB before the timed decoder
    # allocates its own
    frames = bd = None
    bd = BatchDecoder(n_streams=BATCH)
    t0 = time.perf_counter()
    frames = bd.decode(lanes)
    dt = time.perf_counter() - t0
    n = sum(len(f) for f in frames)
    assert n == BATCH * N_FRAMES, (n, BATCH, N_FRAMES)
    return {"e2e_fps": n / dt, "warmup_s": warm_s, "timed_s": dt}


def bench_e2e_device_resident(datas):
    """Same end-to-end decode, but output frames stay on the device
    (BatchDecoder(materialize=False)).  A device checksum over EVERY
    output frame forces the whole pipeline to have executed; only the
    checksum crosses to the host."""
    import jax
    import jax.numpy as jnp
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    lanes = [datas[i % N_SRC] for i in range(BATCH)]
    sums = []
    chk_fn = jax.jit(lambda y: jnp.sum(y.astype(jnp.uint32)))

    def consume(i, f):
        # checksum the frame the moment it is emitted, then drop the
        # planes so device residency stays bounded by the DPB + a round
        sums.append(chk_fn(f.y))
        return None

    def run():
        bd = BatchDecoder(n_streams=BATCH, materialize=False,
                          on_frame=consume)
        t0 = time.perf_counter()
        frames = bd.decode(lanes)
        int(jnp.sum(jnp.stack(sums)))          # sync: all frames decoded
        dt = time.perf_counter() - t0
        n = sum(len(f) for f in frames)
        assert n == BATCH * N_FRAMES == len(sums), (n, len(sums))
        return n / dt

    run()                                      # warmup: compiles
    sums.clear()
    return {"e2e_device_resident_fps": run()}


def bench_d2h():
    """Device->host bandwidth (GB/s) for one round's 1080p luma planes."""
    import jax.numpy as jnp
    import numpy as np
    x = jnp.ones((BATCH, H, W), jnp.uint8) + 0
    np.asarray(x[0, 0, 0])          # force materialization on device
    t0 = time.perf_counter()
    np.asarray(x)
    dt = time.perf_counter() - t0
    return {"d2h_GBps": x.nbytes / dt / 1e9}


def bench_host(datas):
    """Host side alone: the full per-lane pipeline BatchDecoder runs in
    its parse pool (C++ parse + ABI pack + MC-mode select + wire pack +
    commit bookkeeping), no device."""
    import numpy as np
    from arrow_h264_tpu.api import Decoder
    from arrow_h264_tpu.models.pipeline import select_inter_mode
    from arrow_h264_tpu.ops.wire import (
        emit_wire, merge_specs, pack_wire_raw, spec_class,
    )
    zero = (np.zeros((H, W), np.uint8), np.zeros((H // 2, W // 2), np.uint8),
            np.zeros((H // 2, W // 2), np.uint8))
    n = 0
    t0 = time.perf_counter()
    for data in datas:
        dec = Decoder(entropy="cpp")
        spec_sticky: dict = {}
        for pic, poc in dec.parse_pictures(data):
            mb_w = pic.sps.pic_width_in_mbs
            mb_h = pic.sps.pic_height_in_map_units
            abi = dec.pack_abi(pic, poc)
            _mode, _sl, patch = select_inter_mode(abi, mb_w, mb_h)
            abi["patch"] = patch
            raw, spec = pack_wire_raw(abi, mb_w, mb_h)
            cls = spec_class(spec)
            spec_sticky[cls] = spec if cls not in spec_sticky \
                else merge_specs([spec_sticky[cls], spec])
            emit_wire(raw, spec, spec_sticky[cls], mb_w * mb_h)
            list(dec.commit(pic, poc, *zero, 4, lambda *a: None))
            n += 1
    return {"host_parse_fps": n / (time.perf_counter() - t0)}


def _device_batch(inter: bool):
    """Synthetic 1080p batch-32 ABIs + DPBs for the device-only stages."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np
    from arrow_h264_tpu.models.pipeline import (
        ABI_DEVICE_KEYS, decode_frames_batch_fn, dpb_alloc, store_ref_fn,
    )
    from arrow_h264_tpu.ops.synthetic import synthetic_abi, synthetic_abi_p
    from arrow_h264_tpu.ops.transforms import make_ws_consts
    mb_w, mb_h = W // 16, H // 16
    n_slots = 2
    ws4, ws8 = make_ws_consts([[16] * 16] * 6, [[16] * 64] * 2)
    fn = functools.partial(
        decode_frames_batch_fn, mb_w=mb_w, mb_h=mb_h,
        ws4=jnp.asarray(ws4), ws8=jnp.asarray(ws8), cqp_off=(0, 0),
        inter=inter)
    make = (functools.partial(synthetic_abi_p, n_slots=n_slots) if inter
            else synthetic_abi)
    hosts = [make(mb_w, mb_h, seed=i) for i in range(BATCH)]
    abi_b = {k: jnp.asarray(np.stack([h[k] for h in hosts]))
             for k in ABI_DEVICE_KEYS}
    rng = np.random.default_rng(0)
    store = jax.jit(store_ref_fn, donate_argnums=(0, 1))
    dpbs = []
    for i in range(BATCH):
        dpb = dpb_alloc(mb_w, mb_h, n_slots)
        for s in range(n_slots):
            dpb = store(
                *dpb, s,
                jnp.asarray(rng.integers(0, 256, (H, W), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)),
                jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)))
        dpbs.append(dpb)
    dpb_y = jnp.stack([d[0] for d in dpbs])
    dpb_c = jnp.stack([d[1] for d in dpbs])
    return fn, abi_b, dpb_y, dpb_c


def bench_device_only():
    return {"device_recon_fps":
            BATCH / _device_seconds(*_device_batch(inter=True))}


def bench_device_intra():
    return {"device_intra_fps":
            BATCH / _device_seconds(*_device_batch(inter=False))}


# name -> (function, needs the streams, timeout seconds)
STAGES = {
    "host_parse_fps": (bench_host, True, 1200),
    "d2h_GBps": (bench_d2h, False, 600),
    "e2e_fps": (bench_e2e, True, 3600),
    "e2e_device_resident_fps": (bench_e2e_device_resident, True, 3600),
    "device_recon_fps": (bench_device_only, False, 1800),
    "device_intra_fps": (bench_device_intra, False, 1800),
}


def run_stage(name: str) -> None:
    """--stage NAME: run one stage, print one JSON line to stdout."""
    fn, needs_streams, _ = STAGES[name]
    res = fn(make_streams()) if needs_streams else fn()
    import jax
    d = jax.devices()[0]
    res["device"] = {"platform": d.platform, "kind": d.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(res))


def main() -> int:
    if "--stage" in sys.argv:
        run_stage(sys.argv[sys.argv.index("--stage") + 1])
        return 0
    datas = make_streams()       # encoded once; stages reuse the files
    kbit = sum(len(d) for d in datas) * 8 / (N_SRC * N_FRAMES) / 1000
    vals: dict = {}
    failed = []
    for name, (_fn, _needs, timeout_s) in STAGES.items():
        print(f"# stage {name}", file=sys.stderr, flush=True)
        try:
            r = subprocess.run(
                [sys.executable, __file__, "--stage", name],
                timeout=timeout_s, capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            print(f"# stage {name} exceeded {timeout_s}s", file=sys.stderr,
                  flush=True)
            failed.append(name)
            continue
        if r.returncode != 0 or not r.stdout.strip():
            print(f"# stage {name} rc={r.returncode}: {r.stderr[-2000:]}",
                  file=sys.stderr, flush=True)
            failed.append(name)
            continue
        vals.update(json.loads(r.stdout.strip().splitlines()[-1]))
    out = {
        "metric": "1080p decoded frames/sec, end-to-end batched "
                  f"(host parse + upload + recon + store + emit, "
                  f"batch={BATCH} real High/CABAC streams)",
        "value": vals.get("e2e_fps"),
        "unit": "frames/sec",
        "host_cores": os.cpu_count(),
        "n_frames": BATCH * N_FRAMES,
        "stream_kbit_per_frame": kbit,
    }
    out.update({k: v for k, v in vals.items() if k != "e2e_fps"})
    if failed:
        out["failed_stages"] = failed
    print(json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
