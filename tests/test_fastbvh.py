"""Fast binned-SAH builder (native C++ + NumPy fallback): structural
invariants, agreement with the brute-force oracle, quality vs the full-sweep
oracle builder, and build speed."""

import time

import numpy as np
import pytest

from fspt_tpu import native
from fspt_tpu.scene.bvh import build_bvh, triangle_aabbs
from fspt_tpu.scene.fastbvh import _build_numpy, build_bvh_fast


def _random_tris(n, rng):
    centers = rng.uniform(-1, 1, size=(n, 1, 3))
    offsets = rng.normal(size=(n, 3, 3)) * 0.05
    return (centers + offsets).astype(np.float32)


def _check_structure(bvh, n_tris, leaf_size):
    m = bvh.num_nodes
    leaves = bvh.tri_offset >= 0
    internal = ~leaves
    # preorder: children come after their parent, left before right
    assert (bvh.left[internal] > np.arange(m)[internal]).all()
    assert (bvh.right[internal] > bvh.left[internal]).all()
    # every triangle appears exactly once
    slots = bvh.slot_tri[bvh.slot_tri >= 0]
    assert sorted(slots.tolist()) == list(range(n_tris))
    assert len(bvh.slot_tri) % leaf_size == 0
    # leaf offsets are leaf_size-aligned and unique
    offs = bvh.tri_offset[leaves]
    assert (offs % leaf_size == 0).all()
    assert len(set(offs.tolist())) == len(offs)
    # parent boxes contain child boxes
    for i in np.nonzero(internal)[0]:
        for c in (bvh.left[i], bvh.right[i]):
            assert (bvh.node_min[i] <= bvh.node_min[c] + 1e-6).all()
            assert (bvh.node_max[i] >= bvh.node_max[c] - 1e-6).all()


def _sah_cost(bvh):
    """Sum over nodes of surface-area-weighted visit cost (lower=better)."""
    d = np.maximum(bvh.node_max - bvh.node_min, 0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    return float(area[1:].sum() / max(area[0], 1e-12))


@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_fastbvh_structure(rng, builder):
    if builder == "native" and not native.available():
        pytest.skip("no C++ toolchain")
    verts = _random_tris(3000, rng)
    tmin, tmax = triangle_aabbs(verts)
    if builder == "native":
        bvh = build_bvh_fast(tmin, tmax, leaf_size=8)
    else:
        bvh = _build_numpy(tmin.astype(np.float32), tmax.astype(np.float32), 8)
    _check_structure(bvh, 3000, 8)


def test_native_and_numpy_agree(rng):
    """The C++ builder and its NumPy mirror implement the same split rule.
    Float rounding (C++ float vs NumPy float64 promotion) can move boundary
    triangles across bins, so trees are compared by quality and structure,
    not node-for-node."""
    if not native.available():
        pytest.skip("no C++ toolchain")
    verts = _random_tris(500, rng)
    tmin, tmax = triangle_aabbs(verts)
    a = build_bvh_fast(tmin, tmax, leaf_size=4)
    b = _build_numpy(tmin.astype(np.float32), tmax.astype(np.float32), 4)
    _check_structure(a, 500, 4)
    _check_structure(b, 500, 4)
    ca, cb = _sah_cost(a), _sah_cost(b)
    assert abs(ca - cb) < 0.1 * max(ca, cb), (ca, cb)
    # root boxes identical; node counts close
    np.testing.assert_allclose(a.node_min[0], b.node_min[0], atol=1e-6)
    np.testing.assert_allclose(a.node_max[0], b.node_max[0], atol=1e-6)
    assert abs(a.num_nodes - b.num_nodes) <= 0.05 * b.num_nodes


def test_fastbvh_quality_close_to_sweep(rng):
    """Binned SAH should be within 1.5x of the full-sweep oracle's SAH cost."""
    verts = _random_tris(2000, rng)
    tmin, tmax = triangle_aabbs(verts)
    fast = build_bvh_fast(tmin, tmax, leaf_size=8)
    sweep = build_bvh(tmin, tmax, leaf_size=8)
    assert _sah_cost(fast) < 1.5 * _sah_cost(sweep)


def test_fastbvh_renders_identically_to_sweep_via_brute(rng):
    """Traversal over the fast tree finds the same nearest hits as the
    brute-force oracle (tree structure may differ from sweep; hits may not)."""
    import jax.numpy as jnp
    from fspt_tpu.core.traversal import intersect_scene_brute, intersect_scene
    from fspt_tpu.ops import packing

    verts = _random_tris(800, rng)
    tmin, tmax = triangle_aabbs(verts)
    bvh = build_bvh_fast(tmin, tmax, leaf_size=8)

    gather = np.where(bvh.slot_tri < 0, 0, bvh.slot_tri)
    v = verts[gather]
    v[bvh.slot_tri < 0] = 0.0
    tri_v0 = v[:, 0]
    tri_e1 = v[:, 1] - v[:, 0]
    tri_e2 = v[:, 2] - v[:, 0]

    class A:  # minimal arrays view for the jnp reference traversal
        pass

    a = A()
    a.tri_v0 = jnp.asarray(tri_v0)
    a.tri_e1 = jnp.asarray(tri_e1)
    a.tri_e2 = jnp.asarray(tri_e2)
    a.node_left = jnp.asarray(bvh.left)
    a.node_right = jnp.asarray(bvh.right)
    a.node_tri = jnp.asarray(bvh.tri_offset)
    a.node_min = jnp.asarray(bvh.node_min)
    a.node_max = jnp.asarray(bvh.node_max)

    n = 512
    origin = jnp.asarray(rng.uniform(-2, 2, size=(n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    direction = jnp.asarray(d)

    hit = intersect_scene(a, origin, direction, leaf_size=8,
                          stack_depth=2 * (bvh.depth + 2))
    brt = intersect_scene_brute(a, origin, direction)
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(brt.t),
                               rtol=1e-4, atol=1e-5)


def test_fastbvh_speed():
    """82k triangles should build well under a second (VERDICT.md #6)."""
    rng = np.random.default_rng(0)
    verts = _random_tris(82000, rng)
    tmin, tmax = triangle_aabbs(verts)
    build_bvh_fast(tmin, tmax, leaf_size=8)       # warm the native cache
    t0 = time.perf_counter()
    bvh = build_bvh_fast(tmin, tmax, leaf_size=8)
    dt = time.perf_counter() - t0
    _check_structure(bvh, 82000, 8)
    budget = 1.0 if native.available() else 30.0
    assert dt < budget, f"build took {dt:.2f}s"


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_width16_pack_traverse_hit_parity(rng, impl):
    """The 16-wide pack/traverse generalization (kept as a knob; the
    loaders default to 8-wide) must find the same nearest hits as the
    8-wide path, in the kernel (interpret mode) and the plain walk."""
    import functools
    import jax.numpy as jnp
    from fspt_tpu.core.vec import V3
    from fspt_tpu.ops import bvh, packing

    walk = (functools.partial(bvh.walk_kernel, interpret=True)
            if impl == "kernel" else bvh.walk_plain)
    verts = _random_tris(800, rng)
    tmin, tmax = triangle_aabbs(verts)
    bvh_tree = build_bvh_fast(tmin, tmax, leaf_size=8)
    gather = np.where(bvh_tree.slot_tri < 0, 0, bvh_tree.slot_tri)
    v = verts[gather]
    v[bvh_tree.slot_tri < 0] = 0.0
    tri_v0, tri_e1, tri_e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]

    n = 1024
    origin = rng.uniform(-2, 2, size=(3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = V3(*(jnp.asarray(x) for x in origin))
    D = V3(*(jnp.asarray(x) for x in d))

    hits = {}
    for width in (8, 16):
        pk = packing.pack_bvh(bvh_tree.left, bvh_tree.right,
                              bvh_tree.tri_offset, bvh_tree.node_min,
                              bvh_tree.node_max, tri_v0, tri_e1, tri_e2,
                              leaf_size=8, width=width)
        hits[width] = walk(jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
                           O, D, leaf_size=8, width=width,
                           stack_depth=width * (pk.depth + 2))
    np.testing.assert_allclose(np.asarray(hits[8].t),
                               np.asarray(hits[16].t), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(hits[8].slot),
                                  np.asarray(hits[16].slot))


def test_big_scene_hbm_traversal(rng):
    """A 220k-tri soup (~14 MiB of packed tables) traverses with the tables
    in device memory and no size budget: the kernel (interpret mode) must
    return the same nearest hits as the jnp binary-BVH reference
    traversal."""
    import jax.numpy as jnp
    from fspt_tpu.core.traversal import intersect_scene
    from fspt_tpu.core.vec import V3
    from fspt_tpu.ops import bvh, packing

    n_tri = 220_000
    verts = _random_tris(n_tri, rng)
    tmin, tmax = triangle_aabbs(verts)
    bvh_tree = build_bvh_fast(tmin, tmax, leaf_size=8)
    g = np.where(bvh_tree.slot_tri < 0, 0, bvh_tree.slot_tri)
    v = verts[g]
    v[bvh_tree.slot_tri < 0] = 0.0
    tri_v0, tri_e1, tri_e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    pk = packing.pack_bvh(bvh_tree.left, bvh_tree.right, bvh_tree.tri_offset,
                          bvh_tree.node_min, bvh_tree.node_max,
                          tri_v0, tri_e1, tri_e2, leaf_size=8)
    assert (pk.nodes.nbytes + pk.leaves.nbytes) > 12 * 2 ** 20

    m = 512
    o = rng.uniform(-2, 2, size=(3, m)).astype(np.float32)
    d = rng.normal(size=(3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    O = V3(*map(jnp.asarray, o))
    D = V3(*map(jnp.asarray, d))
    hit = bvh.walk_kernel(jnp.asarray(pk.nodes), jnp.asarray(pk.leaves),
                          O, D, leaf_size=8, stack_depth=8 * (pk.depth + 2),
                          interpret=True)

    class A:
        pass

    a = A()
    a.tri_v0 = jnp.asarray(tri_v0)
    a.tri_e1 = jnp.asarray(tri_e1)
    a.tri_e2 = jnp.asarray(tri_e2)
    a.node_left = jnp.asarray(bvh_tree.left)
    a.node_right = jnp.asarray(bvh_tree.right)
    a.node_tri = jnp.asarray(bvh_tree.tri_offset)
    a.node_min = jnp.asarray(bvh_tree.node_min)
    a.node_max = jnp.asarray(bvh_tree.node_max)
    ref = intersect_scene(a, jnp.asarray(o.T), jnp.asarray(d.T), leaf_size=8,
                          stack_depth=2 * (bvh_tree.depth + 2))
    np.testing.assert_allclose(np.asarray(hit.t), np.asarray(ref.t),
                               rtol=1e-4, atol=1e-5)
