"""Batched binary-BVH traversal in plain jnp: the reference's per-thread
stack walk (reference tracer.fs:366-404 intersectScene) over the binary
tree, used by autofocus and as a test oracle (the renderer walks the wide
tables, ops/bvh.py).

Design: rays advance in lockstep through a masked `lax.while_loop`; each ray
carries its own current-node index and a fixed-depth stack (the reference uses
a 64-deep local array, tracer.fs:368).  Per iteration every active lane:
  1. gathers its node record (left, right, tri_offset),
  2. slab-tests both children's AABBs front-to-back,
  3. if at a leaf, intersects the leaf's `leaf_size` triangles (a fixed-size
     vectorized Moller-Trumbore — leaves are padded at build time so no count
     gather is needed),
  4. descends to the near child, deferring the far child to its stack, or pops.

Traversal order and pruning (children skipped unless closer than the current
best hit) match the reference exactly, so the `bvh_heatmap` visit counts are
comparable to the reference's mode=test render (reference bvh_test.fs).

Gradients: traversal is a discrete decision process — the result (t, slot) is
wrapped in stop_gradient by callers; shading re-derives differentiable
quantities from the hit slot.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fspt_tpu.core.geometry import EPSILON, MAX_T, intersect_aabb, intersect_tri


class Hit(NamedTuple):
    t: jnp.ndarray       # (N,) f32 — MAX_T on miss
    slot: jnp.ndarray    # (N,) i32 — padded-slot index, -1 on miss
    visits: jnp.ndarray  # (N,) i32 — traversal iterations (heatmap debug)


def intersect_scene(scene, origin, direction, leaf_size: int = 4,
                    stack_depth: int = 64, max_t: float = MAX_T) -> Hit:
    """Nearest-hit traversal. origin/direction: (N, 3). Returns Hit over N."""
    n = origin.shape[0]
    inv_dir = jnp.reciprocal(
        jnp.where(jnp.abs(direction) < 1e-20,
                  jnp.where(direction < 0, -1e-20, 1e-20), direction))

    node_left = scene.node_left
    node_right = scene.node_right
    node_tri = scene.node_tri
    node_min = scene.node_min
    node_max = scene.node_max
    tri_v0 = scene.tri_v0
    tri_e1 = scene.tri_e1
    tri_e2 = scene.tri_e2

    class State(NamedTuple):
        idx: jnp.ndarray       # (N,) current node, -1 = done
        stack: jnp.ndarray     # (N, stack_depth) i32
        ptr: jnp.ndarray       # (N,) i32 — points one past top
        best_t: jnp.ndarray    # (N,)
        best_slot: jnp.ndarray # (N,) i32
        visits: jnp.ndarray    # (N,) i32

    init = State(
        idx=jnp.zeros(n, jnp.int32),
        stack=jnp.full((n, stack_depth), -1, jnp.int32),
        ptr=jnp.ones(n, jnp.int32),   # stack[0] = -1 sentinel already there
        best_t=jnp.full(n, max_t, jnp.float32),
        best_slot=jnp.full(n, -1, jnp.int32),
        visits=jnp.zeros(n, jnp.int32),
    )

    def cond(s: State):
        return jnp.any(s.idx >= 0)

    def body(s: State) -> State:
        active = s.idx >= 0
        gi = jnp.maximum(s.idx, 0)

        left = node_left[gi]
        right = node_right[gi]
        tri = node_tri[gi]
        is_leaf = tri >= 0

        lh = intersect_aabb(origin, inv_dir, node_min[left], node_max[left],
                            max_t=max_t)
        rh = intersect_aabb(origin, inv_dir, node_min[right], node_max[right],
                            max_t=max_t)

        # ---- leaf: fixed-size vectorized triangle test ----
        base = jnp.maximum(tri, 0)
        slots = base[:, None] + jnp.arange(leaf_size, dtype=jnp.int32)[None, :]
        t_leaf = intersect_tri(
            origin[:, None, :], direction[:, None, :],
            tri_v0[slots], tri_e1[slots], tri_e2[slots], max_t=max_t)
        k = jnp.argmin(t_leaf, axis=-1)
        t_best_leaf = jnp.min(t_leaf, axis=-1)
        leaf_better = active & is_leaf & (t_best_leaf < s.best_t)
        best_t = jnp.where(leaf_better, t_best_leaf, s.best_t)
        best_slot = jnp.where(leaf_better,
                              (base + k.astype(jnp.int32)), s.best_slot)

        # ---- descend / defer / pop (tracer.fs:379-401) ----
        lgo = lh < best_t
        rgo = rh < best_t
        both = ~is_leaf & lgo & rgo
        near = jnp.where(lh > rh, right, left)
        far = jnp.where(lh > rh, left, right)
        one = ~is_leaf & (lgo ^ rgo)
        one_child = jnp.where(lgo, left, right)

        pop = active & ~(both | one)
        new_ptr = jnp.where(active & both, s.ptr + 1,
                            jnp.where(pop, s.ptr - 1, s.ptr))
        # push far child for `both` lanes
        push_pos = jnp.clip(s.ptr, 0, stack_depth - 1)
        stack = jnp.where(
            (active & both)[:, None]
            & (jnp.arange(stack_depth)[None, :] == push_pos[:, None]),
            far[:, None], s.stack)
        popped = jnp.take_along_axis(
            stack, jnp.clip(new_ptr, 0, stack_depth - 1)[:, None], axis=1)[:, 0]

        new_idx = jnp.where(both, near, jnp.where(one, one_child, popped))
        idx = jnp.where(active, new_idx, s.idx)
        visits = s.visits + active.astype(jnp.int32)
        return State(idx=idx, stack=stack, ptr=new_ptr,
                     best_t=best_t, best_slot=best_slot, visits=visits)

    final = jax.lax.while_loop(cond, body, init)
    slot = jnp.where(final.best_t >= max_t, -1, final.best_slot)
    return Hit(t=final.best_t, slot=slot, visits=final.visits)


def intersect_scene_brute(scene, origin, direction,
                          max_t: float = MAX_T) -> Hit:
    """Oracle path used by tests and cfg.intersector='brute'."""
    from fspt_tpu.core.geometry import brute_force_intersect
    t, slot = brute_force_intersect(origin, direction, scene.tri_v0,
                                    scene.tri_e1, scene.tri_e2, max_t=max_t)
    return Hit(t=t, slot=slot, visits=jnp.zeros_like(slot))


def occluded(scene, origin, direction, leaf_size: int = 4,
             stack_depth: int = 64, max_t: float = MAX_T):
    """Shadow-ray predicate: True if anything is hit.  The reference reuses
    full nearest-hit traversal for shadows (tracer.fs:501); we do the same for
    estimator parity (any-hit early-out is a later optimization)."""
    hit = intersect_scene(scene, origin, direction, leaf_size=leaf_size,
                          stack_depth=stack_depth, max_t=max_t)
    return hit.slot >= 0
