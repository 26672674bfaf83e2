"""Persistent XLA compile cache for the entry points.

Called from ``cytv`` (``cli.main``), ``chip_smoke.py`` and ``bench.py``
— never on ``import cytvdn_tpu``, so a library user's own cache settings
stay theirs.
"""

from __future__ import annotations

import os

#: fixed in-checkout cache directory (listed in .gitignore). The path is
#: part of the cache key, so it never depends on a temp name, a pid or
#: the time.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that
    directory and nothing else is set here. Otherwise the cache goes to
    :data:`DEFAULT_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
