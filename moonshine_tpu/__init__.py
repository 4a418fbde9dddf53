"""moonshine_tpu — a ray-traced renderer in JAX for NVIDIA GPUs.

A ground-up JAX/XLA rebuild of the capability surface of the
Moonshine renderer (reference: Zig + Vulkan RT + HLSL). The Vulkan RT
pipeline becomes a software LBVH with stackless traversal (a
per-thread CUDA kernel on the GPU, a batched JAX walk on the CPU); the
HLSL megakernel becomes a vectorized SoA path-tracing loop compiled by
XLA; multi-chip scaling uses `jax.sharding` over pixel/sample meshes.

Subpackages
-----------
core        RNG, warp mappings, reflection frames, alias tables
accel       LBVH build + batched traversal
bsdf        Lambert / StandardPBR(GGX) / mirror / glass, branchless dispatch
lights      environment maps (equal-area + hierarchical sampling), mesh lights
scene       glTF ingest, materials, textures, cameras, world state
integrator  batched path tracer (NEE + MIS + russian roulette)
render      sensor accumulation, offline renderer, progressive engine
io          EXR / PNG codecs
parallel    multi-chip sharding of the render dispatch
"""

__version__ = "0.1.0"
