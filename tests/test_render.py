"""End-to-end render tests: finite images, accumulation determinism,
heatmap mode, checkpoint/resume, tonemap."""

import jax.numpy as jnp
import numpy as np

from fspt_tpu.config import PostConfig, RenderConfig
from fspt_tpu.core.tonemap import aces_fitted, filter_fireflies, postprocess
from fspt_tpu.runtime.renderer import Renderer


def _small_cfg(**kw):
    base = dict(width=32, height=24, bounces=2, extra_refraction_iters=1,
                batch_spp=1)
    base.update(kw)
    return RenderConfig(**base)


def test_render_finite_and_nonzero(small_scene):
    r = Renderer(small_scene, _small_cfg())
    r.step(2)
    hdr = r.hdr_image()
    assert np.isfinite(hdr).all()
    assert hdr.max() > 0.01
    img = r.image()
    assert img.shape == (24, 32, 3)
    assert (img >= 0).all() and (img <= 1).all()


def test_render_deterministic(small_scene):
    cfg = _small_cfg(seed=5)
    a = Renderer(small_scene, cfg).step(2).hdr_image()
    b = Renderer(small_scene, cfg).step(2).hdr_image()
    np.testing.assert_array_equal(a, b)


def test_heatmap_mode(small_scene):
    r = Renderer(small_scene, _small_cfg(mode="bvh_heatmap"))
    r.step()
    hdr = r.hdr_image()
    assert (hdr >= 0).all()
    assert hdr.max() > 0  # some rays visited nodes
    # grayscale
    np.testing.assert_array_equal(hdr[..., 0], hdr[..., 1])
    # per-PIXEL granularity: each ray reports its own node fetches, so
    # counts must vary within every run of 128 neighbouring lanes of the
    # tile-ordered framebuffer, not be block-constant
    from fspt_tpu.runtime.layout import tile_order
    flat = hdr[..., 0].reshape(-1)
    order = np.asarray(tile_order(r.cfg.width, r.cfg.height))
    lanes = flat[order]                      # lane i renders pixel order[i]
    walks = lanes[: (len(lanes) // 128) * 128].reshape(-1, 128)
    frac_varying = (walks.std(axis=1) > 0).mean()
    assert frac_varying > 0.5, (
        f"heatmap looks walk-constant ({frac_varying:.2f} varying)")
    # every ray counts at least the root visit
    assert (flat * (1.0 / r.cfg.heatmap_scale)).min() >= 0.999


def test_checkpoint_resume(small_scene, tmp_path):
    cfg = _small_cfg(seed=9)
    a = Renderer(small_scene, cfg)
    a.step(3)
    ckpt = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(ckpt)
    a.step(2)

    b = Renderer(small_scene, cfg)
    b.load_checkpoint(ckpt)
    b.step(2)
    np.testing.assert_array_equal(a.hdr_image(), b.hdr_image())


def test_brute_vs_packet_integrator_agree(small_scene):
    """Same RNG + same estimator, different intersector ("bvh": the plain
    walk on the CPU): images identical up to float tolerance."""
    cfg_pkt = _small_cfg(seed=3, intersector="bvh")
    cfg_brt = _small_cfg(seed=3, intersector="brute")
    a = Renderer(small_scene, cfg_pkt).step().hdr_image()
    b = Renderer(small_scene, cfg_brt).step().hdr_image()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).mean()
    assert close > 0.995


def test_autofocus_sets_focal_depth(small_scene):
    r = Renderer(small_scene, _small_cfg())
    t = r.autofocus()
    # camera at (0,.4,2.2) looking at sphere radius .5 at origin: hit ~1.6-2.3
    assert 1.0 < t < 3.0
    assert abs(float(r.camera.focal_depth) - t) < 1e-6


def test_aces_behaves():
    black = aces_fitted([jnp.zeros((2, 2))] * 3)
    np.testing.assert_allclose(np.asarray(black), 0.0, atol=1e-3)
    big = aces_fitted([jnp.full((2, 2), 100.0)] * 3)
    assert all((np.asarray(c) > 0.95).all() for c in big)
    mid = aces_fitted([jnp.full((1, 1), 0.18)] * 3)
    assert 0.0 < float(mid[0][0, 0]) < 0.3


def test_firefly_filter_suppresses_outlier():
    plane = jnp.ones((9, 9)) * 0.5
    plane = plane.at[4, 4].set(50.0)
    out = filter_fireflies([plane] * 3, max_sigma=2.0)
    assert float(out[0][4, 4]) < 1.0
    np.testing.assert_allclose(float(out[0][0, 0]), 0.5, rtol=1e-5)


def test_postprocess_pipeline():
    img = jnp.full((3, 4, 4), 0.18)
    out = postprocess(img, exposure=2.0, saturation=0.5, denoise=True)
    assert out.shape == (3, 4, 4)
    assert np.isfinite(np.asarray(out)).all()


def test_emissive_scene_lights_up():
    from fspt_tpu.testing import make_test_scene
    scene = make_test_scene(subdivisions=1, env="gradient",
                            emissive_sphere=True)
    # black env: zero the radiance planes so the light is the only source
    for plane in scene.arrays.env_rgb:
        plane[:] = 0.0
    r = Renderer(scene, _small_cfg(seed=1))
    r.step(2)
    hdr = r.hdr_image()
    assert hdr.max() > 0.0  # emittance term contributes


def test_light_nee_unbiased_vs_bsdf_sampling():
    """Working area-light NEE (the reference's is broken+disabled): with MIS
    the estimator must converge to the same image as BSDF-only sampling."""
    from fspt_tpu.testing import make_test_scene
    scene = make_test_scene(subdivisions=1, env="gradient",
                            emissive_sphere=True)
    for plane in scene.arrays.env_rgb:
        plane[:] = 0.0
    means = {}
    for nee in (False, True):
        cfg = _small_cfg(width=16, height=16, seed=2, intersector="brute",
                         use_light_nee=nee, batch_spp=4)
        r = Renderer(scene, cfg)
        r.step(16)
        means[nee] = float(r.hdr_image().mean())
    assert means[True] > 0
    # both estimate the same integral; agreement within MC noise
    assert abs(means[True] - means[False]) / means[False] < 0.15
