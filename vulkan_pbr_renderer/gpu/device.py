"""Device management — the JAX replacement for GPU_Init/GPU_Deinit.

The reference's GPU_Init (gpu_vulkan.c:945-1140) creates a Vulkan
instance/device/queue and six samplers; here the runtime is jax itself, so
this module is thin: backend detection, interpret-mode policy for Pallas
kernels (CPU testing), and mesh construction for the multi-card path.
"""

from __future__ import annotations

import jax
import numpy as np


def init_devices(retries: int = 3, delay_s: float = 2.0):
    """First device contact with retry on transient runtime-init failures
    (SURVEY §5 failure-detection plan: backend init can fail transiently at
    startup the way Vulkan device creation can; the reference only ever
    asserts, gpu_vulkan.c:387-392 — we retry then surface).
    Returns jax.devices().  Used by the headless/preview entry points; safe
    to call again once initialized (jax caches the backend)."""
    import time

    last = None
    for attempt in range(retries):
        try:
            return jax.devices()
        except RuntimeError as e:  # backend init failures surface as RuntimeError
            last = e
            if attempt + 1 < retries:
                time.sleep(delay_s * (attempt + 1))
    raise RuntimeError(
        f"device init failed after {retries} attempts: {last}"
    ) from last


def backend() -> str:
    return jax.default_backend()


def pallas_interpret() -> bool:
    """Whether Pallas kernels run in the interpreter: on the CPU backend (the
    test suite) they do; on the GPU they compile.  Any other backend has no
    compiled route for the kernels, so it is an error, not a fallback."""
    b = backend()
    if b == "cpu":
        return True
    if b == "gpu":
        return False
    raise RuntimeError(f"no Pallas route for backend {b!r} (cpu or gpu only)")


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> jax.sharding.Mesh:
    """Build a device mesh; default is all devices on one 'sp' axis
    (framebuffer-row sharding; SURVEY.md §2.2 parallelism inventory)."""
    devices = devices if devices is not None else jax.devices()
    if axis_sizes is None:
        axis_sizes = {"sp": len(devices)}
    names = tuple(axis_sizes.keys())
    shape = tuple(axis_sizes.values())
    arr = np.array(devices[: int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(arr, names)
