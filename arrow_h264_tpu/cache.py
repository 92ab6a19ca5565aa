"""On-disk caches, kept inside the checkout and configured here only.

JAX's persistent compilation cache lives where JAX_COMPILATION_CACHE_DIR
says when that is set (JAX reads the variable itself, so nothing is set
in code), and otherwise in `.jax_cache/` at the checkout's root.  The
wire format's sticky specs (ops.wire) sit beside it in
`.wire_specs.json`: they decide which program structures get jitted, so
they stay with the checkout rather than in a home directory that other
checkouts share.
"""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_COMPILE_CACHE = ROOT / ".jax_cache"
SPEC_CACHE = ROOT / ".wire_specs.json"


def compile_cache_dir(environ=os.environ) -> str:
    """The directory the compile cache uses under `environ`."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or \
        str(DEFAULT_COMPILE_CACHE)


def configure() -> None:
    """Point JAX at the checkout's cache unless the environment names one."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir",
                          str(DEFAULT_COMPILE_CACHE))
