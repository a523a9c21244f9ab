"""vulkan_pbr_renderer — a deferred PBR renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
uuwee/Vulkan-PBR-Renderer (a Vulkan 1.3 deferred PBR renderer with dynamic
voxel-grid GI, sun shadow mapping, split-sum IBL, TAA, physically-based bloom
and ACES tonemapping).  Nothing here is a port: the Vulkan render graph,
descriptor sets and GLSL passes are replaced by a single jit-compiled frame
function over jax Arrays, with Pallas kernels for the rasterizer hot path.

Layer map (mirrors SURVEY.md §1, reference file pointers in the docstrings):

  utils/     L0  — math, noise, color, image metrics (replaces HandmadeMath + Fire)
  gpu/       L2  — device/resource/sampling runtime (replaces src/gpu/gpu_vulkan.c)
  raster/    L3' — visibility-buffer tile rasterizer (replaces fixed-function raster)
  shade/     L3' — BRDF library + lighting/TAA/bloom/tonemap passes (replaces *.glsl)
  bake/      L3' — one-time IBL precompute (replaces gen_*.glsl compute passes)
  assets/    L4  — glTF/FBX/DDS/HDR/TGA loaders + procedural scenes (replaces asset_import.cpp)
  app/       L4  — renderer orchestration, camera, headless CLI (replaces main.cpp/render.cpp)
  parallel/  —   multi-card sharding of the frame (new capability; reference is single-GPU)
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry math (vertex transforms, matrix inverses) must run at true f32: a
# reduced-precision f32 matmul (TF32 on the GPU, bf16 passes elsewhere)
# quantizes clip-space positions into garbage depth.  The renderer has no
# large matmuls where lower precision would pay, so force full precision.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the full frame takes minutes to compile and
# every fresh process recompiles it.  JAX_COMPILATION_CACHE_DIR, when set, is
# the cache (JAX reads it itself); otherwise a fixed .jax_cache/ beside the
# package, inside the checkout (the path is part of the cache key, so it
# must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 10.0)
