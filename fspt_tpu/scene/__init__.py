"""Host-side scene compilation: parsers, atlas packing, environment analysis,
BVH construction, and flattening into the device-side SceneArrays pytree.

This layer is the replacement for the reference's JS scene compiler
(reference obj_loader.js / mtl_loader.js / texture_packer.js / env_sampler.js /
main.js initBVH): pure NumPy (with optional C++ fast paths), no GL round-trips.
"""
