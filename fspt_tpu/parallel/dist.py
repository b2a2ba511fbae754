"""Sharded render and differentiable train steps over a device mesh.

Design (see also BASELINE.md north star):
  * one mesh axis ("rays"): the framebuffer's pixel tiles are evenly sharded;
    each device ray-gens and traces only its own tile (scene pytree
    replicated).  Forward rendering needs NO collectives — tiles are disjoint.
  * the differentiable train step computes per-tile losses against a target
    image and all-reduces (psum) parameter gradients — materials, atlas, env
    map, camera — across the mesh, the renderer-shaped analog of data-parallel
    gradient sync.

Multi-host: build the mesh over jax.devices() after
jax.distributed.initialize(); the same shard_map code spans the cards of
one host and several hosts.  The mesh is 1-D: the four cards of a host are
joined all to all, so no mesh shape follows a topology.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fspt_tpu.config import RenderConfig
from fspt_tpu.core.camera import generate_rays
from fspt_tpu.core.integrator import trace_paths
from fspt_tpu.core.rng import sample_key, stream_uniforms
from fspt_tpu.runtime.layout import tile_order


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = "rays") -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def shard_accum(accum, mesh: Mesh):
    """Place the (3, N) accumulation buffer column-sharded over the mesh."""
    return jax.device_put(
        accum, NamedSharding(mesh, P(None, mesh.axis_names[0])))


def _deal_chunks(n: int, n_dev: int):
    """Round-robin chunk assignment of the canonical lane space to shards.

    Contiguous band assignment puts whole image regions on one device, and
    the scaling meter (parallel/scaling.py) measured only 65% load-balance
    efficiency that way — sky bands terminate after the primary miss while
    geometry bands trace full paths.  Dealing packet-sized chunks of the
    tile order round-robin spreads every image region across all shards.

    Returns (n,) int32 canonical lane ids in shard-major dealt order
    (shard s owns positions [s*local, (s+1)*local)).
    """
    local = n // n_dev
    # one traversal packet (= one 32x32 tile) per chunk keeps packets
    # coherent, but guarantee >= 8 chunks per shard so small images still
    # spread across the frame
    chunk = max(1, min(1024, local // 8))
    while local % chunk:
        chunk //= 2
    n_chunks = n // chunk
    order = np.concatenate([np.arange(s, n_chunks, n_dev)
                            for s in range(n_dev)])
    return (np.arange(n, dtype=np.int32).reshape(n_chunks, chunk)[order]
            .reshape(-1))


def make_sharded_sample_step(mesh: Mesh, cfg: RenderConfig, meta):
    """Returns jitted step(scene, cam, accum, count, base_key, sample_idx)
    -> (accum, count, shard_rays) with accum sharded over the mesh's ray
    axis and the scene replicated.  shard_rays is (n_dev,) — honest
    active-lane rays traced per device this step (TraceStats), the input to
    the load-balance efficiency meter in parallel/scaling.py.

    The returned function carries `.pixel_order`: accum column j holds the
    radiance sum of pixel pixel_order[j] (shard-dealt chunk order — NOT the
    single-device renderer's tile order; scatter by pixel id to compare)."""
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = cfg.width * cfg.height
    if n % n_dev:
        raise ValueError(f"pixels {n} not divisible by {n_dev} devices")
    local = n // n_dev
    resolution = (cfg.width, cfg.height)
    perm = np.asarray(tile_order(cfg.width, cfg.height), np.int32)
    lane_ids_all = _deal_chunks(n, n_dev)          # canonical lane ids
    pixel_order = perm[lane_ids_all]               # pixel ids, dealt order
    lane_ids_dev = jnp.asarray(lane_ids_all)
    pixels_dev = jnp.asarray(pixel_order)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(None, axis), P(), P(), P()),
        out_specs=(P(None, axis), P(), P(axis)),
        check_vma=False)
    def inner(scene, cam, accum, count, base_key, sample_idx):
        shard = jax.lax.axis_index(axis)
        offset = shard * local
        pixel_idx = jax.lax.dynamic_slice_in_dim(pixels_dev, offset, local)
        # The RNG is keyed by CANONICAL lane index (core/rng.py), not by
        # shard: every shard draws exactly the per-pixel streams the
        # single-device renderer draws for its lanes, so the sharded render
        # is bit-identical to the local one (tests/test_parallel.py).
        lane_ids = jax.lax.dynamic_slice_in_dim(lane_ids_dev, offset, local)
        key = sample_key(base_key, sample_idx)

        def one_sample(spp_i, carry):
            acc, rays = carry
            k = jax.random.fold_in(key, spp_i)
            cam_u = stream_uniforms(k, 0, (4, local), lane_offset=lane_ids)
            origin, direction = generate_rays(
                cam.position, cam.direction, cam.fov_scale, cam.focal_depth,
                cam.aperture, resolution, cam_u, pixel_idx=pixel_idx)
            r, stats = trace_paths(scene, cfg, meta, origin, direction, k,
                                   lane_offset=lane_ids, return_stats=True)
            return acc + jnp.stack([r.x, r.y, r.z]), rays + stats.rays

        accum, rays = jax.lax.fori_loop(0, cfg.batch_spp, one_sample,
                                        (accum, jnp.float32(0.0)))
        # count is replicated; bump on all shards identically
        return accum, count + cfg.batch_spp, rays.reshape(1)

    jitted = jax.jit(inner, donate_argnums=(2,))

    def step(*args, **kwargs):
        return jitted(*args, **kwargs)

    step.pixel_order = pixel_order
    return step


# ---------------------------------------------------------------------------
# differentiable train step (inverse rendering) with gradient all-reduce
# ---------------------------------------------------------------------------

PARAM_FIELDS = ("emit", "ior", "dielectric",
                "atlas_r", "atlas_g", "atlas_b", "env_rgb")


def split_params(scene):
    """Trainable material/env parameters out of SceneArrays."""
    return {f: getattr(scene, f) for f in PARAM_FIELDS}


def merge_params(scene, params, cam, cam_params):
    scene = scene._replace(**params)
    cam = cam._replace(position=cam_params["position"],
                       direction=cam_params["direction"])
    return scene, cam


def make_train_step(mesh: Mesh, cfg: RenderConfig, meta):
    """Returns jitted train_step(params, cam_params, scene, cam, target,
    base_key, step_idx) -> (loss, grads, cam_grads).

    target: (3, N) sharded over rays (tile order).  Gradients of the
    replicated parameters are psum'd across the mesh — the all-reduce the
    reference never needed (single GPU) but several devices do.
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = cfg.width * cfg.height
    if n % n_dev:
        raise ValueError(f"pixels {n} not divisible by {n_dev} devices")
    local = n // n_dev
    resolution = (cfg.width, cfg.height)
    perm = np.asarray(tile_order(cfg.width, cfg.height), np.int32)
    lane_ids_all = _deal_chunks(n, n_dev)
    pixel_order = perm[lane_ids_all]
    lane_ids_dev = jnp.asarray(lane_ids_all)
    pixels_dev = jnp.asarray(pixel_order)

    def local_loss(params, cam_params, scene, cam, target_local, key,
                   pixel_idx, lane_ids):
        scene, cam = merge_params(scene, params, cam, cam_params)
        cam_u = stream_uniforms(key, 0, (4, local), lane_offset=lane_ids)
        origin, direction = generate_rays(
            cam.position, cam.direction, cam.fov_scale, cam.focal_depth,
            cam.aperture, resolution, cam_u, pixel_idx=pixel_idx)
        r = trace_paths(scene, cfg, meta, origin, direction, key,
                        lane_offset=lane_ids)
        radiance = jnp.stack([r.x, r.y, r.z])
        return jnp.mean((radiance - target_local) ** 2)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(None, axis), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False)
    def inner(params, cam_params, scene, cam, target, base_key, step_idx):
        shard = jax.lax.axis_index(axis)
        offset = shard * local
        pixel_idx = jax.lax.dynamic_slice_in_dim(pixels_dev, offset, local)
        lane_ids = jax.lax.dynamic_slice_in_dim(lane_ids_dev, offset, local)
        key = sample_key(base_key, step_idx)
        loss, (grads, cam_grads) = jax.value_and_grad(
            local_loss, argnums=(0, 1))(params, cam_params, scene, cam,
                                        target, key, pixel_idx, lane_ids)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.lax.pmean(grads, axis)
        cam_grads = jax.lax.pmean(cam_grads, axis)
        return loss, grads, cam_grads

    jitted = jax.jit(inner)

    def step(*args, **kwargs):
        return jitted(*args, **kwargs)

    step.pixel_order = pixel_order
    return step
