"""Finite-difference validation of the differentiable render path
(round-1 VERDICT item 4; SURVEY §7.2.8).

The integrator detaches discrete events — hit selection (traversal inputs
are stop_gradient'ed, core/integrator.py intersect), lobe choice, env-bin
pick — and differentiates the continuous factors (BRDF throughputs, texture
fetches, env radiance, MIS weights, camera ray directions).  For parameters
whose influence is purely continuous, jax.grad must therefore agree with a
central finite difference of the SAME estimator at the SAME RNG streams:

  * env map texels (radiance is linear in them through NEE + escape + miss),
  * atlas texels (diffuse/emissive/metallicRoughness fetches),
  * per-slot constant emittance,
  * camera direction on an all-miss scene (radiance = env(dir(cam))) —
    geometry discontinuities (silhouettes) are excluded by construction.

NOT validated by FD, by design: parameters that move detached discrete
decisions — hit distances (geometry), ior (flips the fresnel-vs-uniform
lobe comparison tracer.fs:475), bin boundaries.  FD across such a flip
measures the jump; AD deliberately reports the smooth part only.

All checks are directional derivatives (grad . v vs central difference
along a fixed random direction v) — one scalar comparison per parameter
group, robust to f32 noise on individual texels.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fspt_tpu.config import RenderConfig
from fspt_tpu.core.camera import generate_rays
from fspt_tpu.core.integrator import trace_paths
from fspt_tpu.core.rng import sample_key, stream_uniforms
from fspt_tpu.core.vec import V3
from fspt_tpu.testing import make_test_scene


SIZE = 12


@pytest.fixture(scope="module")
def setup():
    scene = make_test_scene(subdivisions=1, textured=True, metallic=0.3,
                            roughness=0.5)
    arrays = scene.device_arrays()
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=2,
                       extra_refraction_iters=0, intersector="brute")
    n = SIZE * SIZE
    key = sample_key(jax.random.key(11), 0)
    cam = scene.camera
    cam_u = stream_uniforms(key, 0, (4, n))
    origin, direction = generate_rays(
        jnp.asarray(cam.position), jnp.asarray(cam.direction),
        cam.fov_scale, cam.focal_depth, cam.aperture, (SIZE, SIZE), cam_u)
    return scene, arrays, cfg, origin, direction, key


def _loss(arrays, cfg, meta, origin, direction, key):
    r = trace_paths(arrays, cfg, meta, origin, direction, key)
    return (jnp.mean(r.x) + jnp.mean(r.y) + jnp.mean(r.z)) / 3.0


def _check_directional(f, x0, seed, h, rel_tol, abs_floor=1e-7, v_mask=None):
    """grad(f)(x0) . v  vs  (f(x0 + h v) - f(x0 - h v)) / 2h."""
    g = jax.grad(f)(x0)
    rng = np.random.default_rng(seed)
    v = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), x0)
    if v_mask is not None:
        v = jax.tree.map(lambda a: a * v_mask, v)
    ad = sum(float(jnp.vdot(gi, vi)) for gi, vi
             in zip(jax.tree.leaves(g), jax.tree.leaves(v)))
    xp = jax.tree.map(lambda a, b: a + h * b, x0, v)
    xm = jax.tree.map(lambda a, b: a - h * b, x0, v)
    fd = (float(f(xp)) - float(f(xm))) / (2.0 * h)
    denom = max(abs(fd), abs(ad), abs_floor)
    assert abs(ad - fd) / denom < rel_tol, (ad, fd)
    assert abs(ad) > abs_floor, "gradient is numerically zero — vacuous test"


def test_fd_env_map(setup):
    scene, arrays, cfg, origin, direction, key = setup

    def f(env_planes):
        a = arrays._replace(env_rgb=V3(*env_planes))
        return _loss(a, cfg, scene.meta, origin, direction, key)

    x0 = (arrays.env_rgb.x, arrays.env_rgb.y, arrays.env_rgb.z)
    _check_directional(f, x0, seed=1, h=5e-3, rel_tol=2e-2)


def test_fd_env_map_nearest_fusion(setup):
    """Gradients must also flow through the round-5 nearest-texel env
    path (nee_env_nearest / escape_env_nearest — the production config):
    NEE radiance is a single env6-row gather whose VJP scatters back onto
    the env planes, and the loss is piecewise-linear in the texels, so
    AD must match FD exactly away from texel boundaries."""
    import dataclasses
    scene, arrays, cfg, origin, direction, key = setup
    cfgn = dataclasses.replace(cfg, nee_env_nearest=True,
                               escape_env_nearest=True)

    def f(env_planes):
        a = arrays._replace(env_rgb=V3(*env_planes))
        return _loss(a, cfgn, scene.meta, origin, direction, key)

    x0 = (arrays.env_rgb.x, arrays.env_rgb.y, arrays.env_rgb.z)
    _check_directional(f, x0, seed=2, h=5e-3, rel_tol=2e-2)


def test_fd_atlas(setup):
    """Atlas texels, EXCLUDING metallicRoughness AND normal-map layers: both
    move the detached lobe-select threshold (tracer.fs:475 — sg(p_specular)
    > u; metallic directly, the normal map through micro_n -> Schlick
    fresnel), so FD across either measures lobe flips AD deliberately
    ignores.  Measured: including map_n layers gives a 17% AD/FD gap from
    flips alone; masked, AD matches FD to 0.02% (round-2 VERDICT weak #2).
    Diffuse/emissive layers influence radiance continuously; the gather VJP
    itself (incl. normal layers) is unit-tested in test_fd_atlas_fetch_vjp.
    Operating point shifted +0.1 so the clip(color, 0, ..) kink
    (tracer.fs:515) is never crossed by the +-h*v excursions."""
    scene, arrays, cfg, origin, direction, key = setup
    r = scene.meta.atlas_res
    mask = np.ones(arrays.atlas_r.shape[0], np.float32)
    lobe_moving = np.concatenate([np.asarray(arrays.map_mr),
                                  np.asarray(arrays.map_n)])
    for layer in np.unique(lobe_moving):
        mask[layer * r * r:(layer + 1) * r * r] = 0.0
    mask = jnp.asarray(mask)

    def f(planes):
        a = arrays._replace(atlas_r=planes[0], atlas_g=planes[1],
                            atlas_b=planes[2])
        return _loss(a, cfg, scene.meta, origin, direction, key)

    x0 = (arrays.atlas_r + 0.1, arrays.atlas_g + 0.1, arrays.atlas_b + 0.1)
    _check_directional(f, x0, seed=2, h=2e-3, rel_tol=4e-2, v_mask=mask)


def test_fd_atlas_fetch_vjp(setup):
    """Direct FD check of atlas_fetch_rgb alone (round-2 VERDICT item 2):
    validates the row-gather bilinear-fetch VJP with NO shading logic in the
    loop, covering every layer kind (incl. the normal/mr layers the
    end-to-end test must mask).  The fetch is exactly linear in the texel
    planes, so AD and FD must agree to f32 roundoff."""
    from fspt_tpu.core.integrator import atlas_fetch_rgb
    scene, arrays, cfg, origin, direction, key = setup
    meta = scene.meta
    rng = np.random.default_rng(7)
    m = 257
    n_layers = arrays.atlas_r.shape[0] // (meta.atlas_res ** 2)
    layer = jnp.asarray(rng.integers(0, n_layers, m), jnp.int32)
    # include out-of-[0,1) coords to exercise the REPEAT wrap
    u = jnp.asarray(rng.uniform(-0.5, 1.5, m), jnp.float32)
    v = jnp.asarray(rng.uniform(-0.5, 1.5, m), jnp.float32)
    w = jnp.asarray(rng.standard_normal((3, m)), jnp.float32)

    def f(planes):
        a = arrays._replace(atlas_r=planes[0], atlas_g=planes[1],
                            atlas_b=planes[2])
        out = atlas_fetch_rgb(a, meta, layer, u, v)
        return jnp.mean(w[0] * out.x + w[1] * out.y + w[2] * out.z)

    x0 = (arrays.atlas_r, arrays.atlas_g, arrays.atlas_b)
    _check_directional(f, x0, seed=9, h=1e-2, rel_tol=1e-3)


def test_fd_emittance(setup):
    scene, arrays, cfg, origin, direction, key = setup

    def f(emit_planes):
        a = arrays._replace(emit=V3(*emit_planes))
        return _loss(a, cfg, scene.meta, origin, direction, key)

    # positive operating point: at emit=0 the clip-at-0 kink sits exactly on
    # the test point and central differences straddle it
    base = jnp.full_like(arrays.emit.x, 0.2)
    x0 = (base, base, base)
    # radiance is exactly linear in constant emittance -> tight tolerance
    _check_directional(f, x0, seed=3, h=5e-3, rel_tol=1e-2)


def test_fd_camera_direction_all_miss():
    """Camera direction gradient on an all-miss scene: radiance =
    env(dir(cam)) is smooth, so AD must equal FD with no geometry caveats."""
    scene = make_test_scene(subdivisions=1, env="sky")
    arrays = scene.device_arrays()
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=1,
                       extra_refraction_iters=0, intersector="brute")
    n = SIZE * SIZE
    key = sample_key(jax.random.key(12), 0)
    cam_u = stream_uniforms(key, 0, (4, n))
    pos = jnp.asarray((0.0, 0.3, 2.2), jnp.float32)

    def f(cam_dir):
        origin, direction = generate_rays(
            pos, cam_dir, 0.2, 1e6, 0.0, (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, scene.meta, origin, direction, key)

    # away from the procedural sun disk (sun_u=0.25 -> dir ~ (0, *, +z));
    # the sun edge is a near-discontinuity that FD would straddle
    view_dir = jnp.asarray((0.3, 0.5, -0.8), jnp.float32)
    _check_directional(f, view_dir, seed=4, h=5e-4, rel_tol=3e-2)


def test_fd_camera_lens_all_miss():
    """Aperture and focal-depth gradients on an all-miss scene (round-3
    VERDICT missing #3): the thin-lens offset moves the ray direction
    smoothly (core/camera.py:69-75 — the DOF disk shifts origin and the
    focal point scales with 1 - 1/focalDepth), so with every ray missing,
    radiance = env(direction(aperture, focal_depth)) and AD must equal FD.
    Camera *position* is excluded here by construction: position cancels
    out of the pinhole/thin-lens direction (d = normalize(screen - origin)
    with both containing +pos), so its all-miss gradient is exactly zero —
    see test_fd_camera_position_light_nee for its nonzero path.
    Gradient env, not "sky": the sun disk's edge makes the loss too
    nonlinear in the lens spread for FD to converge at f32 (measured:
    fd(h) drifts 6.5e-4 -> 4e-5 over h in [5e-4, 2e-2] with sky; with the
    smooth gradient fd matches ad to 0.15%)."""
    scene = make_test_scene(subdivisions=1, env="gradient")
    arrays = scene.device_arrays()
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=1,
                       extra_refraction_iters=0, intersector="brute")
    n = SIZE * SIZE
    key = sample_key(jax.random.key(13), 0)
    cam_u = stream_uniforms(key, 0, (4, n))
    pos = jnp.asarray((0.0, 0.3, 2.2), jnp.float32)
    view_dir = jnp.asarray((0.3, 0.5, -0.8), jnp.float32)

    def f(lens):
        aperture, focal_depth = lens
        origin, direction = generate_rays(
            pos, view_dir, 0.2, focal_depth, aperture, (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, scene.meta, origin, direction, key)

    x0 = (jnp.float32(0.3), jnp.float32(2.0))
    _check_directional(f, x0, seed=5, h=5e-3, rel_tol=3e-2)


def test_fd_camera_position_light_nee():
    """Camera-position gradient (round-3 VERDICT missing #3).  Position
    cancels out of ray directions (camera.py:61-75), and the hit distance t
    is detached, so the surviving continuous path is the light-NEE
    geometry: hit_p = origin + t*d moves with the camera, changing the
    sampled light's distance/pdf and lobe evals (integrator.py light_wanted
    branch).  AD treats t as constant; FD re-traces, so agreement requires
    dt/dpos = 0 along the probe direction — guaranteed by moving the camera
    PARALLEL to the flat floor (v_mask zeroes the y component).  The floor
    is untextured (uv slide would otherwise show up in FD only, through the
    detached barycentrics)."""
    scene = make_test_scene(subdivisions=1, env="gradient", textured=False,
                            emissive_sphere=True)
    arrays = scene.device_arrays()
    cfg = RenderConfig(width=SIZE, height=SIZE, bounces=1,
                       extra_refraction_iters=0, intersector="brute",
                       use_light_nee=True)
    n = SIZE * SIZE
    key = sample_key(jax.random.key(14), 0)
    cam_u = stream_uniforms(key, 0, (4, n))
    view_dir = jnp.asarray((0.0, -0.8, -0.6), jnp.float32)  # down at floor

    def f(pos):
        origin, direction = generate_rays(
            pos, view_dir, 0.3, 1e6, 0.0, (SIZE, SIZE), cam_u)
        return _loss(arrays, cfg, scene.meta, origin, direction, key)

    pos0 = jnp.asarray((0.9, 0.9, 2.0), jnp.float32)
    v_mask = jnp.asarray((1.0, 0.0, 1.0), jnp.float32)   # in-plane only
    _check_directional(f, pos0, seed=6, h=2e-3, rel_tol=4e-2, v_mask=v_mask)


def test_light_nee_mis_matches_bsdf_only():
    """Unbiasedness of the emitter-hit MIS path (round-3 VERDICT weak #6):
    with area-light NEE on, every unit of emitted radiance is split between
    the NEE sample (weight w_l) and the BSDF-sampled emitter hit (weight
    w_hit, integrator.py emit_add); the weights are complementary power
    heuristics, so the multi-sample mean must converge to the SAME image as
    the pure BSDF-sampling estimator (use_light_nee=False), which needs no
    weights at all.  A wrong w_hit (or pdf_l) shows up as a biased mean;
    'finite and nonzero' (the old coverage) would not catch it."""
    import dataclasses
    scene = make_test_scene(subdivisions=1, env="gradient", textured=False,
                            emissive_sphere=True)
    arrays = scene.device_arrays()
    cfg0 = RenderConfig(width=16, height=16, bounces=2,
                        extra_refraction_iters=0, use_light_nee=False)
    cfg1 = dataclasses.replace(cfg0, use_light_nee=True)
    n = 16 * 16
    cam = scene.camera
    tp0 = jax.jit(lambda o, d, k: trace_paths(arrays, cfg0, scene.meta,
                                              o, d, k))
    tp1 = jax.jit(lambda o, d, k: trace_paths(arrays, cfg1, scene.meta,
                                              o, d, k))
    m0 = np.zeros(3)
    m1 = np.zeros(3)
    S = 96
    for s in range(S):
        key = sample_key(jax.random.key(21), s)
        cam_u = stream_uniforms(key, 0, (4, n))
        origin, direction = generate_rays(
            jnp.asarray(cam.position), jnp.asarray(cam.direction),
            cam.fov_scale, cam.focal_depth, cam.aperture, (16, 16), cam_u)
        r0 = tp0(origin, direction, key)
        r1 = tp1(origin, direction, key)
        m0 += np.array([float(jnp.mean(r0.x)), float(jnp.mean(r0.y)),
                        float(jnp.mean(r0.z))])
        m1 += np.array([float(jnp.mean(r1.x)), float(jnp.mean(r1.y)),
                        float(jnp.mean(r1.z))])
    m0 /= S
    m1 /= S
    assert (m1 > 0).all()
    # MIS reduces variance but must not move the mean; 96 samples x 256
    # lanes puts the MC error of the means well under 6%
    np.testing.assert_allclose(m1, m0, rtol=0.06)


def test_brdf_square_roots_have_finite_gradients_at_zero():
    """A GGX sample whose cos_theta is 1 (u2 = 0), a Smith/Schlick/refract
    argument at 0: the gradient w.r.t. roughness and ior must be finite
    (sqrt(max(x, 0)) alone gives inf * 0 = NaN there)."""
    import jax
    from fspt_tpu.core import brdf
    from fspt_tpu.core.vec import V3

    n = V3(jnp.zeros(2), jnp.zeros(2), jnp.ones(2))
    u = jnp.array([0.3, 0.7], jnp.float32)

    def f(rough, ior):
        m = brdf.sample_microfacet(n, rough, u, jnp.zeros(2))
        inc = V3(jnp.zeros(2), jnp.ones(2), jnp.zeros(2))   # grazing
        fr = brdf.schlick(inc, n, ior, jnp.ones(2))
        r = brdf.refract(V3(jnp.ones(2), jnp.zeros(2), jnp.zeros(2)), n,
                         ior)
        g = brdf.smith_g(jnp.zeros(2), rough * 0.0)
        return jnp.sum(m.x + m.y + m.z + fr + r.x + r.y + r.z + g)

    gr, gi = jax.grad(f, argnums=(0, 1))(jnp.full(2, 0.3), jnp.full(2, 1.5))
    assert np.isfinite(np.asarray(gr)).all()
    assert np.isfinite(np.asarray(gi)).all()
