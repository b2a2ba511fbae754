"""Tests that need an NVIDIA GPU: the traversal kernel as compiled for the
card.  They skip elsewhere (tests/conftest.py); chip_smoke.py runs them on
the card, or: FSPT_TEST_ON_DEVICE=1 python -m pytest -m gpu tests/"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fspt_tpu.config import RenderConfig
from fspt_tpu.core.vec import V3
from fspt_tpu.ops import bvh

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", ["nearest", "any_hit", "tmax"])
def test_compiled_kernel_matches_plain_walk(small_scene, mode):
    a, m = small_scene.device_arrays(), small_scene.meta
    rng = np.random.default_rng(3)
    n = 3000
    o = V3(*jnp.asarray(rng.uniform(-2, 2, (3, n)), jnp.float32))
    d = rng.normal(size=(3, n))
    d = V3(*jnp.asarray(d / np.linalg.norm(d, axis=0), jnp.float32))
    tmax = (jnp.asarray(rng.uniform(0.05, 2.0, n), jnp.float32)
            if mode == "tmax" else None)
    kw = dict(leaf_size=m.leaf_size, width=m.bvh_width,
              stack_depth=m.pk_stack_depth, any_hit=mode == "any_hit")
    got = jax.jit(lambda o, d: bvh.walk_kernel(a.pk_nodes, a.pk_leaves, o, d,
                                               tmax, **kw))(o, d)
    ref = jax.jit(lambda o, d: bvh.walk_plain(a.pk_nodes, a.pk_leaves, o, d,
                                              tmax, **kw))(o, d)
    np.testing.assert_array_equal(np.asarray(got.slot), np.asarray(ref.slot))
    np.testing.assert_array_equal(np.asarray(got.visits),
                                  np.asarray(ref.visits))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(ref.u),
                               atol=1e-5)


def test_render_step_calls_kernel_and_matches_plain(small_scene):
    from fspt_tpu.runtime.renderer import Renderer
    cfg = dict(width=32, height=32, bounces=2, extra_refraction_iters=0,
               batch_spp=2, seed=2, compact=True, sort_state=True)
    r = Renderer(small_scene, RenderConfig(intersector="bvh", **cfg))
    text = r._step.lower(r.arrays, cam=r.camera, accum=r.accum,
                         count=r.count, rays=r.rays, base_key=r.base_key,
                         sample_idx=0, pixel_idx=r.pixel_idx).as_text()
    assert "bvh_walk" in text
    p = Renderer(small_scene, RenderConfig(intersector="plain", **cfg))
    a, b = r.step(2).hdr_image(), p.step(2).hdr_image()
    assert np.isfinite(a).all()
    assert np.isclose(a, b, rtol=1e-3, atol=1e-4).mean() > 0.995
