"""The wide-BVH traversal (ops/bvh.py): the Pallas kernel in interpret
mode against the plain walk, and the choice between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fspt_tpu.config import RenderConfig
from fspt_tpu.core.vec import V3
from fspt_tpu.ops import bvh

N = 1000          # not a multiple of any kernel block


@pytest.fixture(scope="module")
def case(small_scene):
    arrays = small_scene.device_arrays()
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, size=(3, N)).astype(np.float32)
    d = rng.normal(size=(3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    clip = rng.uniform(0.05, 2.0, size=N).astype(np.float32)
    clip[::7] = 0.0                         # parked rays start done
    kw = dict(leaf_size=small_scene.meta.leaf_size,
              width=small_scene.meta.bvh_width,
              stack_depth=small_scene.meta.pk_stack_depth)
    return (arrays.pk_nodes, arrays.pk_leaves, V3(*jnp.asarray(o)),
            V3(*jnp.asarray(d)), jnp.asarray(clip), kw)


def _assert_same(got, ref):
    np.testing.assert_array_equal(np.asarray(got.slot), np.asarray(ref.slot))
    np.testing.assert_array_equal(np.asarray(got.visits),
                                  np.asarray(ref.visits))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(ref.v),
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["nearest", "any_hit", "tmax"])
def test_kernel_matches_plain_walk(case, mode):
    nodes, leaves, o, d, clip, kw = case
    tmax = clip if mode == "tmax" else None
    any_hit = mode == "any_hit"
    got = bvh.walk_kernel(nodes, leaves, o, d, tmax, any_hit=any_hit,
                          interpret=True, **kw)
    ref = bvh.walk_plain(nodes, leaves, o, d, tmax, any_hit=any_hit, **kw)
    assert got.t.shape == (N,)
    _assert_same(got, ref)


@pytest.mark.parametrize("block", [64, 128])
def test_kernel_block_padding(case, block):
    """Other block sizes pad N differently; results must not change, and
    rays with tmax 0 finish at once: no hit, no visit, t == 0."""
    nodes, leaves, o, d, clip, kw = case
    got = bvh.walk_kernel(nodes, leaves, o, d, clip, block=block,
                          interpret=True, **kw)
    ref = bvh.walk_plain(nodes, leaves, o, d, clip, **kw)
    _assert_same(got, ref)
    parked = np.asarray(clip) == 0.0
    assert (np.asarray(got.visits)[parked] == 0).all()
    assert (np.asarray(got.slot)[parked] == -1).all()
    assert (np.asarray(got.t)[parked] == 0.0).all()


def test_visits_count_wide_nodes_root_included(case):
    nodes, leaves, o, d, _, kw = case
    hit = bvh.walk_plain(nodes, leaves, o, d, **kw)
    visits = np.asarray(hit.visits)
    assert visits.min() >= 1                    # every ray fetches the root
    assert visits.max() <= nodes.shape[0]       # each node at most once
    assert visits.max() > 1


@pytest.mark.parametrize("name", ["split", "walk", "packet", "kernel"])
def test_intersector_rejects_unknown_names(name):
    with pytest.raises(ValueError, match="intersector"):
        RenderConfig(intersector=name)


def test_bvh_intersector_takes_plain_walk_on_cpu(case):
    """traverse() compiled for the CPU lowers the plain walk, never the
    Triton kernel, and returns exactly what walk_plain returns."""
    nodes, leaves, o, d, clip, kw = case
    fn = jax.jit(lambda o, d, t: bvh.traverse(nodes, leaves, o, d, t, **kw))
    text = fn.lower(o, d, clip).as_text()
    assert "triton" not in text and "bvh_walk" not in text
    got = fn(o, d, clip)
    ref = jax.jit(lambda o, d, t: bvh.walk_plain(nodes, leaves, o, d, t,
                                                 **kw))(o, d, clip)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))


def test_plain_intersector_matches_bvh_render(small_scene):
    from fspt_tpu.runtime.renderer import Renderer
    cfg = dict(width=16, height=16, bounces=2, extra_refraction_iters=0,
               batch_spp=1, seed=4)
    a = Renderer(small_scene, RenderConfig(intersector="bvh", **cfg))
    b = Renderer(small_scene, RenderConfig(intersector="plain", **cfg))
    np.testing.assert_array_equal(a.step().hdr_image(), b.step().hdr_image())


def test_render_step_lowers_kernel_for_cuda_only(small_scene):
    """Lowered for CUDA (no card needed), the production render step holds
    the Triton traversal kernel; lowered for the CPU it holds none."""
    import dataclasses
    from fspt_tpu.runtime.renderer import Renderer
    cfg = RenderConfig(width=32, height=32, bounces=2, batch_spp=2,
                       compact=True, wavefront_batch=True, sort_state=True)
    r = Renderer(small_scene, cfg)
    traced = r._step.trace(r.arrays, cam=r.camera, accum=r.accum,
                           count=r.count, rays=r.rays, base_key=r.base_key,
                           sample_idx=0, pixel_idx=r.pixel_idx)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in cuda and "bvh_walk" in cuda
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" not in cpu
    plain = dataclasses.replace(cfg, intersector="plain")
    r = Renderer(small_scene, plain)
    traced = r._step.trace(r.arrays, cam=r.camera, accum=r.accum,
                           count=r.count, rays=r.rays, base_key=r.base_key,
                           sample_idx=0, pixel_idx=r.pixel_idx)
    assert "triton" not in traced.lower(
        lowering_platforms=("cuda",)).as_text()
