"""Device kernels: the device tier of the framework.

The reference's device tier is five GLSL fragment shaders (reference
shader/*.fs); here it is the wide-BVH traversal (ops/bvh.py: a Pallas
kernel compiled through Triton for the GPU, and its plain jnp walk) over
the packed scene tables of ops/packing.py.
"""
