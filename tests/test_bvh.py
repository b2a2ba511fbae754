"""BVH build + traversal: structural invariants and equivalence with the
brute-force oracle on random rays."""

import jax.numpy as jnp
import pytest
import numpy as np

from fspt_tpu.core.traversal import intersect_scene, intersect_scene_brute
from fspt_tpu.scene.bvh import build_bvh, triangle_aabbs


def _random_tris(n, rng):
    centers = rng.uniform(-1, 1, size=(n, 1, 3))
    offsets = rng.normal(size=(n, 3, 3)) * 0.1
    return (centers + offsets).astype(np.float32)


def test_bvh_structure(rng):
    verts = _random_tris(100, rng)
    bvh = build_bvh(*triangle_aabbs(verts), leaf_size=8)
    m = bvh.num_nodes
    leaves = bvh.tri_offset >= 0
    # internal children indices are valid and preorder (> parent)
    internal = ~leaves
    assert (bvh.left[internal] > np.arange(m)[internal]).all()
    assert (bvh.right[internal] > bvh.left[internal]).all()
    # every original triangle appears exactly once in slots
    slots = bvh.slot_tri[bvh.slot_tri >= 0]
    assert sorted(slots.tolist()) == list(range(100))
    # each node's box contains its children's boxes
    for i in np.nonzero(internal)[0]:
        for c in (bvh.left[i], bvh.right[i]):
            assert (bvh.node_min[i] <= bvh.node_min[c] + 1e-6).all()
            assert (bvh.node_max[i] >= bvh.node_max[c] - 1e-6).all()
    # leaf slot runs are padded to leaf_size
    assert len(bvh.slot_tri) % 8 == 0


def test_bvh_single_triangle():
    verts = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], dtype=np.float32)
    bvh = build_bvh(*triangle_aabbs(verts), leaf_size=8)
    assert bvh.num_nodes == 1
    assert bvh.tri_offset[0] == 0


def test_traversal_matches_brute_force(small_scene):
    arrays = small_scene.device_arrays()
    rng = np.random.default_rng(7)
    n = 256
    origin = jnp.asarray(
        rng.uniform(-2, 2, size=(n, 3)).astype(np.float32))
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    direction = jnp.asarray(direction)

    hit_bvh = intersect_scene(arrays, origin, direction, leaf_size=8)
    hit_brt = intersect_scene_brute(arrays, origin, direction)

    np.testing.assert_allclose(np.asarray(hit_bvh.t), np.asarray(hit_brt.t),
                               rtol=1e-4, atol=1e-5)
    # slots must agree wherever distances are uniquely determined
    same = np.asarray(hit_bvh.slot) == np.asarray(hit_brt.slot)
    assert same.mean() > 0.99


def test_traversal_axis_aligned_rays(small_scene):
    """Axis-aligned rays exercise the inv-dir guards (zero components)."""
    arrays = small_scene.device_arrays()
    origin = jnp.array([[0.0, 0.0, 2.0], [0.0, 2.0, 0.0], [2.0, 0.0, 0.0]],
                       dtype=jnp.float32)
    direction = jnp.array([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0],
                           [-1.0, 0.0, 0.0]], dtype=jnp.float32)
    hit = intersect_scene(arrays, origin, direction, leaf_size=8)
    brt = intersect_scene_brute(arrays, origin, direction)
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(brt.t),
                               rtol=1e-4)


def test_traversal_visit_counts_reasonable(small_scene):
    """Heatmap diagnostics: visits bounded by node count, > 0 for hits."""
    arrays = small_scene.device_arrays()
    origin = jnp.array([[0.0, 0.4, 2.2]], dtype=jnp.float32)
    direction = jnp.array([[0.0, -0.18, -0.98]], dtype=jnp.float32)
    direction = direction / jnp.linalg.norm(direction)
    hit = intersect_scene(arrays, origin, direction, leaf_size=8)
    assert int(hit.visits[0]) > 0
    assert int(hit.visits[0]) <= len(arrays.node_left) * 2


def _walk(impl):
    """The wide-BVH traversal under test: the Pallas kernel in interpret
    mode, or the plain jnp walk (ops/bvh.py)."""
    import functools
    from fspt_tpu.ops import bvh
    if impl == "kernel":
        return functools.partial(bvh.walk_kernel, interpret=True)
    return bvh.walk_plain


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_packet_traverse_matches_brute(small_scene, impl):
    """Wide-BVH traversal (kernel in interpret mode, and the plain walk) vs
    the brute-force oracle: slots, t, and barycentrics."""
    from fspt_tpu.core.vec import V3

    arrays = small_scene.device_arrays()
    meta = small_scene.meta
    rng = np.random.default_rng(11)
    n = 2048
    o = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    origin = V3(*jnp.asarray(o))
    direction = V3(*jnp.asarray(d))
    hit = _walk(impl)(arrays.pk_nodes, arrays.pk_leaves, origin, direction,
                      leaf_size=8, stack_depth=meta.pk_stack_depth)
    brt = intersect_scene_brute(arrays, jnp.asarray(o.T), jnp.asarray(d.T))
    np.testing.assert_array_equal(np.asarray(hit.slot), np.asarray(brt.slot))
    hits = np.asarray(hit.slot) >= 0
    np.testing.assert_allclose(np.asarray(hit.t)[hits],
                               np.asarray(brt.t)[hits], rtol=1e-5)
    # barycentrics reconstruct the hit point
    gi = np.maximum(np.asarray(hit.slot), 0)
    v0 = np.asarray(arrays.tri_v0)[gi]
    e1 = np.asarray(arrays.tri_e1)[gi]
    e2 = np.asarray(arrays.tri_e2)[gi]
    p_bary = v0 + np.asarray(hit.u)[:, None] * e1 + np.asarray(hit.v)[:, None] * e2
    p_ray = o.T + d.T * np.asarray(hit.t)[:, None]
    err = np.abs(p_bary - p_ray)[hits]
    assert err.max() < 1e-3


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_packet_any_hit_matches_occlusion(small_scene, impl):
    from fspt_tpu.core.vec import V3

    arrays = small_scene.device_arrays()
    rng = np.random.default_rng(12)
    n = 1024
    o = rng.uniform(-1, 1, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    hit = _walk(impl)(arrays.pk_nodes, arrays.pk_leaves,
                      V3(*jnp.asarray(o)), V3(*jnp.asarray(d)),
                      leaf_size=8, any_hit=True,
                      stack_depth=small_scene.meta.pk_stack_depth)
    brt = intersect_scene_brute(arrays, jnp.asarray(o.T), jnp.asarray(d.T))
    np.testing.assert_array_equal(np.asarray(hit.slot) >= 0,
                                  np.asarray(brt.slot) >= 0)
