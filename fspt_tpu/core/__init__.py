"""Device-side compute core (JAX): geometry, BVH traversal, BRDF, environment
sampling, camera ray generation, RNG, tonemapping, and the path-tracing
integrator.  Everything is batched SoA over rays — the vectorized equivalent
of the reference's per-pixel GLSL megakernel (reference shader/tracer.fs).
"""
