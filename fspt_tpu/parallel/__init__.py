"""Distribution layer: device meshes, ray/tile sharding, collective
reductions.  The reference has no distribution of any kind (single browser
GPU, SURVEY.md §2); this is a new first-class component: rays are sharded
over a jax mesh, framebuffer tiles stay device-local, and parameter
gradients are all-reduced (psum) inside shard_map.
"""
