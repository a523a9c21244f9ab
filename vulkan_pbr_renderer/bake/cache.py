"""Bake cache: persist IBL outputs + decoded assets as npz.

The reference has no checkpointing (SURVEY.md §5 'Checkpoint / resume':
everything is rebuilt at startup); we exceed it by caching the one-time
bakes keyed on their inputs, cutting renderer startup.
"""

from __future__ import annotations

import hashlib
import os

import jax.numpy as jnp
import numpy as np

# VPR_BAKE_CACHE overrides; the default stays inside the checkout
DEFAULT_CACHE_DIR = os.environ.get("VPR_BAKE_CACHE") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".bake_cache",
)


def _key(name, *parts):
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, (np.ndarray, jnp.ndarray)):
            h.update(np.ascontiguousarray(np.asarray(p, np.float32)).tobytes()[:65536])
            h.update(str(np.asarray(p).shape).encode())
        else:
            h.update(repr(p).encode())
    return f"{name}-{h.hexdigest()[:16]}"


def cached_bake(name, fn, *key_parts, cache_dir=None, enabled=True):
    """Run fn() or load its cached result; result must be a single array."""
    if not enabled:
        return fn()
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, _key(name, *key_parts) + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return jnp.asarray(z["arr"])
    out = fn()
    np.savez_compressed(path, arr=np.asarray(out))
    return out
