"""Smoke check of the decoder's main path on a GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # four cards: the sharded batch only

One card: builds the host entropy library, decodes the committed
conformance streams of configs 1-4 through `api.Decoder`, then 32 lanes
of 1080p High/CABAC (8 frames each) through `parallel.batch.BatchDecoder`
on a one-device mesh, twice (cold, then warm).  Every frame must hash to
its committed libavcodec golden (smoke/hashes.json; the reconstruction is
integer arithmetic, so the tolerance is zero).  `--four` runs only the
32-lane batch, on a 4-device mesh with 8 lanes per card, and checks that
each card holds its own shard of the DPB and of the outputs.

Timing, compile and memory lines are informational.  The last line of
standard output is one JSON object naming the device; any failed phase
exits non-zero before it is printed.  There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

N_LANES = 32
CONFIGS = ("c1_qcif", "c2_cif", "c3_720p", "c4_1080p")
LANE_SOURCES = ("lane_1080p_a", "lane_1080p_b")


def say(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class CompileClock:
    """Collects JAX's backend-compile durations (jax.monitoring events;
    a persistent-cache load counts as a compile of its load time)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax
        self.events: list[tuple[float, str]] = []
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, fun_name="?", **_kw):
        if event == self.EVENT:
            self.events.append((duration, fun_name))

    def lap(self) -> str:
        """Summary of the compiles since the last lap, slowest two named."""
        ev, self.events = sorted(self.events, reverse=True), []
        top = ", ".join(f"{name} {d:.2f} s" for d, name in ev[:2])
        return (f"{len(ev)} compiles, {sum(d for d, _ in ev):.2f} s "
                f"compiling; slowest: {top or 'none'}")

    def seconds(self) -> float:
        return sum(d for d, _ in self.events)


def card_lines() -> list[str]:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return [ln.strip() for ln in r.stdout.strip().splitlines()]


def check_frames(label: str, frames, hashes: list[str]) -> None:
    from tools.make_smoke_streams import frame_hash
    if len(frames) != len(hashes):
        fail(f"{label}: {len(frames)} frames, golden has {len(hashes)}")
    for k, (f, want) in enumerate(zip(frames, hashes)):
        if frame_hash(f.planar()) != want:
            fail(f"{label}: frame {k} differs from the golden decode")


def phase_conformance(clock: CompileClock) -> None:
    from arrow_h264_tpu.api import Decoder
    from tools.make_smoke_streams import load
    for name in CONFIGS:
        data, hashes = load(name)
        t0 = time.perf_counter()
        frames = list(Decoder().decode_annexb(data))
        dt = time.perf_counter() - t0
        check_frames(name, frames, hashes)
        say(f"config {name}: {len(frames)} frames bit-exact, {dt:.2f} s "
            f"({clock.lap()})")


def dot_report(hlo: str) -> dict:
    """(result type, op) -> count for the dots and GEMM calls of a
    compiled HLO module: says whether an int32 dot stayed an integer
    dot or became a float GEMM."""
    out = collections.Counter()
    for line in hlo.splitlines():
        call = re.search(r'custom_call_target="([^"]+)"', line)
        if " dot(" in line:
            op = "dot"
        elif call and re.search(r"gemm|cublas|matmul", call.group(1), re.I):
            op = call.group(1)
        else:
            continue
        ty = re.search(r"=\s*\(?(\w+)\[", line)
        out[f"{ty.group(1) if ty else '?'} {op}"] += 1
    return dict(out)


def phase_batch(mesh, clock: CompileClock, four: bool) -> None:
    import jax
    from arrow_h264_tpu.parallel.batch import BatchDecoder
    from tools.make_smoke_streams import load

    sources = [load(name) for name in LANE_SOURCES]
    lanes = [sources[i % len(sources)] for i in range(N_LANES)]
    n_dev = mesh.devices.size
    per_dev = N_LANES // n_dev

    def run(label: str):
        bd = BatchDecoder(N_LANES, mesh=mesh)
        calls: dict = {}
        make = bd._decode_fn

        def spy(inter):
            fn = make(inter)

            def call(*args):
                out = fn(*args)
                calls[inter] = (fn, jax.tree.map(
                    lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                                   sharding=a.sharding),
                    args), out[0].sharding, out[0].shape)
                return out
            return call

        bd._decode_fn = spy
        t0 = time.perf_counter()
        frames = bd.decode([d for d, _ in lanes])
        dt = time.perf_counter() - t0
        errs = [(i, e) for i, e in enumerate(bd.errors) if e is not None]
        if errs:
            fail(f"batch {label}: lane errors {errs[:2]}")
        for i, (rows, (_, hashes)) in enumerate(zip(frames, lanes)):
            check_frames(f"batch {label} lane {i}", rows, hashes)
        n = sum(len(r) for r in frames)
        c_s = clock.seconds()
        say(f"batch {label}: {N_LANES} lanes x {n // N_LANES} frames, "
            f"{n} frames bit-exact in {dt:.2f} s = {n / dt:.2f} frames/s, "
            f"{n / (dt - c_s):.2f} frames/s without compiles "
            f"({clock.lap()})")
        if four:
            for arr, what in ((bd._dpb_y, "DPB luma"),
                              (bd._dpb_c, "DPB chroma")):
                shards = arr.addressable_shards
                devs = {s.device for s in shards}
                if len(devs) != n_dev or any(
                        s.data.shape[0] != per_dev for s in shards):
                    fail(f"{what} is not sharded {per_dev} lanes per card")
            for inter, (_fn, _a, sharding, shape) in calls.items():
                if len(sharding.device_set) != n_dev or \
                        sharding.shard_shape(shape)[0] != per_dev:
                    fail(f"output of the inter={inter} program is not "
                         f"sharded {per_dev} lanes per card")
            say(f"sharding: DPB and outputs hold {per_dev} lanes on each "
                f"of {n_dev} cards")
        return calls

    run("cold")
    calls = run("warm")
    for inter in sorted(calls):
        fn, args, _, _ = calls[inter]
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        dt = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        fields = ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes")
        say(f"program inter={inter}: lower+compile again {dt:.2f} s; "
            "memory_analysis " + json.dumps(
                {f: getattr(mem, f, None) for f in fields}))
        say(f"program inter={inter}: dots {json.dumps(dot_report(compiled.as_text()))}")
    for d in mesh.devices.flat:
        stats = d.memory_stats() or {}
        say(f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}, "
            f"bytes_limit {stats.get('bytes_limit')}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 32-lane batch, sharded over 4 cards")
    args = ap.parse_args()

    import jax
    import numpy as np
    from jax.sharding import Mesh

    say(f"devices: {jax.devices()}")
    if jax.default_backend() != "gpu":
        fail(f"JAX backend is {jax.default_backend()!r}, not a GPU")
    n_need = 4 if args.four else 1
    if args.four and len(jax.devices()) != 4:
        fail(f"--four needs 4 devices, found {len(jax.devices())}")
    cards = card_lines()
    for ln in cards:
        say(f"card: {ln}")

    from arrow_h264_tpu.host import centropy
    t0 = time.perf_counter()
    centropy.load_lib()
    say(f"host entropy library ready in {time.perf_counter() - t0:.2f} s")

    clock = CompileClock()
    if not args.four:
        phase_conformance(clock)
    mesh = Mesh(np.array(jax.devices()[:n_need]), ("stream",))
    phase_batch(mesh, clock, four=args.four)

    for ln in cards:
        say(f"card: {ln}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
