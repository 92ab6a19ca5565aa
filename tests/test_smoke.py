"""The smoke path off the card: chip_smoke.py refuses a CPU backend, the
compile and spec caches stay where the cache rule puts them, and the
committed smoke streams decode on the CPU to their committed hashes."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **kw)
    return env


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=_env(), capture_output=True, text=True,
                       timeout=300, cwd=str(REPO))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not a GPU" in r.stderr


_PROBE = """
import json, jax, jax.numpy as jnp
import arrow_h264_tpu
from arrow_h264_tpu.ops.wire import _spec_cache_path
jax.jit(lambda x: jnp.cumsum(x * 3) + 1)(jnp.arange(1000)).block_until_ready()
print(json.dumps([jax.config.jax_compilation_cache_dir, _spec_cache_path()]))
"""


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_rule(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR, when set, is the compile cache and the
    program sets no other; otherwise the cache is the checkout's
    .jax_cache/.  The sticky wire specs stay inside the checkout."""
    import json
    from arrow_h264_tpu import cache
    outside = tmp_path / "cc"
    env = _env(JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(outside)
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    cache_dir, spec_path = json.loads(r.stdout.strip().splitlines()[-1])
    want = str(outside) if from_env else str(REPO / ".jax_cache")
    assert cache_dir == want == cache.compile_cache_dir(env)
    assert Path(spec_path).parent == REPO
    if from_env:
        assert any(outside.iterdir()), "compiled program not cached there"


@pytest.mark.parametrize("name", ["c1_qcif", "c2_cif"])
def test_smoke_streams_decode_to_committed_hashes(name):
    from arrow_h264_tpu.api import Decoder
    from tools.make_smoke_streams import frame_hash, load
    data, hashes = load(name)
    frames = list(Decoder().decode_annexb(data))
    assert [frame_hash(f.planar()) for f in frames] == hashes
