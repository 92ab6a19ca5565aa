"""H.264 decoder: host entropy decode, JAX reconstruction."""

from .cache import configure as _configure_caches

_configure_caches()
