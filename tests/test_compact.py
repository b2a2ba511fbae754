"""Active-lane compaction (core/integrator._compact) correctness.

The compaction pipeline statically shrinks the path state between bounce
iterations, Russian-roulette-reweighting when live lanes exceed the next
width.  Three contracts:

1. A non-shrinking schedule is bit-exact vs the uncompacted estimator
   (pure state reshuffle; all per-lane RNG is keyed by global lane id).
2. A shrinking schedule that stays above the live-lane count is still
   sample-exact (selection keeps every active lane with weight 1) — and
   the state really is re-bucketed (widths verified via _compact_groups).
3. A schedule tight enough to force RR is *unbiased*: the multi-sample
   mean matches the uncompacted estimator within MC tolerance, and every
   survivor's throughput reweighting keeps radiance finite.

Widths are rounded up to 1024-lane packets, so compaction can only
execute at >= 2048 lanes and RR only fires when live lanes exceed 1024:
these tests run at 64x64 (4096 lanes) where, on the subdiv-1 test scene,
~2383 lanes survive the primary hit (forcing RR under schedule (4,)) and
~803 survive bounce 0 (fitting exactly in a 1024 budget under (1, 4)).
TraceStats.rr_lanes counts the lanes RR actually dropped, so each test
asserts its intended regime really occurred instead of vacuously passing
on a full-width no-op (round-3 ADVICE item 1).

(The reference has no analog — a WebGL fragment shader retires dead pixels
for free; XLA's static shapes make this an explicit, testable subsystem.
Reference bounce loop: /root/reference/shader/tracer.fs:436-518.)
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from fspt_tpu.config import RenderConfig
from fspt_tpu.core.camera import generate_rays
from fspt_tpu.core.integrator import _compact_groups, trace_paths
from fspt_tpu.core.rng import sample_key, stream_uniforms
from fspt_tpu.testing import make_test_scene

SIZE = 64
N = SIZE * SIZE


def _rays(scene, s_idx):
    cam = scene.camera
    key = sample_key(jax.random.key(0), s_idx)
    cam_u = stream_uniforms(key, 0, (4, N))
    origin, direction = generate_rays(
        jnp.asarray(cam.position), jnp.asarray(cam.direction),
        cam.fov_scale, cam.focal_depth, cam.aperture,
        (SIZE, SIZE), cam_u)
    return origin, direction, key


def _img(r):
    return np.stack([np.asarray(r.x), np.asarray(r.y), np.asarray(r.z)])


def test_compact_noshrink_exact():
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    o, d, key = _rays(scene, 0)
    cfg0 = RenderConfig(width=SIZE, height=SIZE, bounces=3, compact=False)
    cfg1 = dataclasses.replace(cfg0, compact=True,
                               compact_schedule=(1, 1, 1))
    assert _compact_groups(cfg1, N) == [[N, cfg1.max_iters]]  # pure no-op
    a0 = _img(trace_paths(arrays, cfg0, meta, o, d, key))
    a1 = _img(trace_paths(arrays, cfg1, meta, o, d, key))
    np.testing.assert_allclose(a0, a1, atol=1e-6)


def test_compact_underbudget_exact():
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    o, d, key = _rays(scene, 1)
    cfg0 = RenderConfig(width=SIZE, height=SIZE, bounces=3, compact=False)
    # real 4x shrink after bounce 0 (4096 -> 1024 lanes), but ~803 live
    # lanes fit the budget, so RR never fires and the compacted estimator
    # must agree lane-for-lane (fp association differences only)
    cfg1 = dataclasses.replace(cfg0, compact=True,
                               compact_schedule=(1, 4))
    groups = _compact_groups(cfg1, N)
    assert groups == [[N, 1], [1024, cfg1.max_iters - 1]], groups
    a0 = _img(trace_paths(arrays, cfg0, meta, o, d, key))
    r1, st = trace_paths(arrays, cfg1, meta, o, d, key, return_stats=True)
    a1 = _img(r1)
    assert float(st.rr_lanes) == 0.0          # the no-RR regime really held
    assert np.isfinite(a1).all()
    # scatter-add accumulation reassociates fp adds; exactness up to ulps
    np.testing.assert_allclose(a0, a1, atol=1e-5)


def test_compact_rr_unbiased():
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    cfg0 = RenderConfig(width=SIZE, height=SIZE, bounces=3, compact=False)
    # brutal schedule: 1024 lanes from the PRE-bounce-0 compaction on, vs
    # ~2383 primary hits — forces RR on every sample
    cfg1 = dataclasses.replace(cfg0, compact=True, compact_schedule=(4,))
    assert _compact_groups(cfg1, N) == [[1024, cfg1.max_iters]]
    tp0 = jax.jit(lambda o, d, k: trace_paths(arrays, cfg0, meta, o, d, k))
    tp1 = jax.jit(lambda o, d, k: trace_paths(
        arrays, cfg1, meta, o, d, k, return_stats=True))
    m0 = np.zeros(3)
    m1 = np.zeros(3)
    rr_total = 0.0
    S = 24
    for s in range(S):
        o, d, key = _rays(scene, s)
        a0 = _img(tp0(o, d, key))
        r1, st = tp1(o, d, key)
        a1 = _img(r1)
        rr_total += float(st.rr_lanes)
        assert np.isfinite(a1).all()
        m0 += a0.mean(axis=(1,))
        m1 += a1.mean(axis=(1,))
    assert rr_total > 0, "schedule never forced RR — test is vacuous"
    m0 /= S
    m1 /= S
    # secondary-bounce contributions (the RR-noised part) are a fraction of
    # total radiance; S x 4096 lanes of RR noise sits well under 5%
    np.testing.assert_allclose(m1, m0, rtol=0.05)


def test_wavefront_batch_exact():
    """Cross-sample wavefront batching (trace_paths_batched): K samples
    traced as one path state must reproduce the K sequential trace_paths
    results exactly (per-lane RNG keyed by (sample key, local lane) —
    core/rng.stream_uniforms key_rows) whenever the schedule never forces
    RR — the same exactness contract as compaction itself."""
    from fspt_tpu.core.integrator import trace_paths_batched
    from fspt_tpu.core.vec import V3
    import jax.numpy as jnp
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    cfg = dataclasses.replace(
        RenderConfig(width=SIZE, height=SIZE, bounces=3),
        compact=True, compact_schedule=(1, 4))
    K = 4
    base = sample_key(jax.random.key(0), 7)
    per = []
    seq = np.zeros((3, N))
    for k in range(K):
        kk = jax.random.fold_in(base, k)
        cam = scene.camera
        cam_u = stream_uniforms(kk, 0, (4, N))
        o, d = generate_rays(
            jnp.asarray(cam.position), jnp.asarray(cam.direction),
            cam.fov_scale, cam.focal_depth, cam.aperture, (SIZE, SIZE),
            cam_u)
        per.append((o, d))
        seq += _img(trace_paths(arrays, cfg, meta, o, d, kk))
    cat = lambda f: jnp.concatenate([f(o, d) for o, d in per])
    O = V3(cat(lambda o, d: o.x), cat(lambda o, d: o.y),
           cat(lambda o, d: o.z))
    D = V3(cat(lambda o, d: d.x), cat(lambda o, d: d.y),
           cat(lambda o, d: d.z))
    r, st = trace_paths_batched(arrays, cfg, meta, O, D, base, n_per=N,
                                return_stats=True)
    assert float(st.rr_lanes) == 0.0
    np.testing.assert_allclose(_img(r), seq, atol=2e-5)


def test_wavefront_batch_renderer_rr_finite():
    """Renderer integration of the batched path under an RR-forcing
    schedule: radiance stays finite, sample accounting is per-sample, and
    the batched mean is statistically consistent with the unbatched one."""
    from fspt_tpu.runtime.renderer import Renderer
    cfgA = RenderConfig(width=32, height=32, bounces=3, batch_spp=4,
                        compact=True, compact_schedule=(4,),
                        wavefront_batch=True)
    cfgB = dataclasses.replace(cfgA, wavefront_batch=False)
    scene = make_test_scene(subdivisions=1, textured=True)
    ra = Renderer(scene, cfgA).step(4)
    rb = Renderer(scene, cfgB).step(4)
    assert float(ra.count) == 16.0
    ia, ib = ra.hdr_image(), rb.hdr_image()
    assert np.isfinite(ia).all()
    np.testing.assert_allclose(ia.mean(), ib.mean(), rtol=0.1)


def test_wavefront_batch_nonpow2_boundary():
    """batch_spp that does NOT divide the first merged width: K*ceil(w/K)
    exceeds it, so the pre-merge per-sample shrink is followed by a second
    compaction at the same iteration index in the merged phase.  Round-4
    ADVICE item 1: both used RNG stream _RR_STREAM + it with identical
    per-sample keys/local lane ids, making the two survivor selections
    deterministically identical and biasing the estimator; the shrink now
    draws from stream base _RR_STREAM + max_iters.  This test pins the
    regime (replicating the group split arithmetic) and asserts the
    estimator stays finite and consistent with the unbatched mean."""
    from fspt_tpu.core.integrator import _compact_groups, trace_paths_batched
    from fspt_tpu.core.vec import V3
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    K = 6
    cfg = dataclasses.replace(
        RenderConfig(width=SIZE, height=SIZE, bounces=3),
        compact=True, compact_schedule=(1, 24),
        wavefront_batch=True, batch_spp=K, wavefront_merge_width=1024)
    # replicate trace_paths_batched's split: phase A covers widths above
    # merge_width; the first merged group must not be divisible by K
    groups = _compact_groups(cfg, N)
    split = next(i for i, (w, _) in enumerate(groups)
                 if w <= cfg.wavefront_merge_width)
    its_a = sum(c for _, c in groups[:split])
    merged = _compact_groups(cfg, K * N)
    itx, groups_b = 0, []
    for w, count in merged:
        take = max(0, min(count, itx + count - its_a))
        if take and itx + count > its_a:
            groups_b.append([w, take])
        itx += count
    w_b = -(-groups_b[0][0] // K)
    assert K * w_b > groups_b[0][0], (
        "config no longer triggers the double-compact boundary; "
        f"K={K} w_b={w_b} first merged width={groups_b[0][0]}")
    base = sample_key(jax.random.key(0), 11)
    per = []
    seq = np.zeros((3, N))
    for k in range(K):
        kk = jax.random.fold_in(base, k)
        cam = scene.camera
        cam_u = stream_uniforms(kk, 0, (4, N))
        o, d = generate_rays(
            jnp.asarray(cam.position), jnp.asarray(cam.direction),
            cam.fov_scale, cam.focal_depth, cam.aperture, (SIZE, SIZE),
            cam_u)
        per.append((o, d))
        seq += _img(trace_paths(arrays, dataclasses.replace(
            cfg, wavefront_batch=False, batch_spp=1), meta, o, d, kk))
    cat = lambda f: jnp.concatenate([f(o, d) for o, d in per])
    O = V3(cat(lambda o, d: o.x), cat(lambda o, d: o.y),
           cat(lambda o, d: o.z))
    D = V3(cat(lambda o, d: d.x), cat(lambda o, d: d.y),
           cat(lambda o, d: d.z))
    r, st = trace_paths_batched(arrays, cfg, meta, O, D, base, n_per=N,
                                return_stats=True)
    img = _img(r)
    assert float(st.rr_lanes) > 0, "boundary never forced RR — vacuous"
    assert np.isfinite(img).all()
    # RR noise on the secondary-bounce share of a 4096-lane x6 batch
    np.testing.assert_allclose(img.mean(), seq.mean(), rtol=0.08)


def test_sort_state_exact():
    """State-sort mode (cfg.sort_state: permute the path state into Morton
    order each iteration instead of sorting every launch) must reproduce
    the launch-sorted estimator exactly — lane order never enters the
    estimator (RNG keyed by gid, deposits by lidx).  Run both with and
    without compaction."""
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    o, d, key = _rays(scene, 3)
    cfg0 = RenderConfig(width=SIZE, height=SIZE, bounces=3)
    for extra in ({}, {"compact": True, "compact_schedule": (1, 4)}):
        cA = dataclasses.replace(cfg0, sort_state=False, **extra)
        cB = dataclasses.replace(cfg0, sort_state=True, **extra)
        aA = _img(trace_paths(arrays, cA, meta, o, d, key))
        aB = _img(trace_paths(arrays, cB, meta, o, d, key))
        np.testing.assert_allclose(aA, aB, atol=2e-5)


def test_nearest_env_statistical_parity():
    """nee_env_nearest + escape_env_nearest (round-5 shading-gather
    fusion) swap bilinear env filtering for nearest-texel on NEE and
    scatter-escape lookups — a different but equally consistent MC target
    (the nearest-filtered env), so images must agree statistically, not
    bitwise: multi-sample means within the filtering difference of the
    smooth test sky."""
    scene = make_test_scene(subdivisions=1, textured=True, env="sky")
    arrays, meta = scene.device_arrays(), scene.meta
    cfgA = RenderConfig(width=SIZE, height=SIZE, bounces=3)
    cfgB = dataclasses.replace(cfgA, nee_env_nearest=True,
                               escape_env_nearest=True)
    mA = np.zeros(3)
    mB = np.zeros(3)
    for s in range(4):
        o, d, key = _rays(scene, s)
        a = _img(trace_paths(arrays, cfgA, meta, o, d, key))
        b = _img(trace_paths(arrays, cfgB, meta, o, d, key))
        assert np.isfinite(b).all()
        mA += a.mean(axis=1)
        mB += b.mean(axis=1)
    np.testing.assert_allclose(mB, mA, rtol=0.02)


def test_packed_textures_parity():
    scene = make_test_scene(subdivisions=1, textured=True)
    arrays, meta = scene.device_arrays(), scene.meta
    o, d, key = _rays(scene, 2)
    cfgA = RenderConfig(width=SIZE, height=SIZE, bounces=3,
                        packed_textures=True)
    cfgB = dataclasses.replace(cfgA, packed_textures=False)
    aA = _img(trace_paths(arrays, cfgA, meta, o, d, key))
    aB = _img(trace_paths(arrays, cfgB, meta, o, d, key))
    # same bilinear math, different fp association (packed rows fold the
    # x-lerp before the y-lerp)
    np.testing.assert_allclose(aA, aB, atol=1e-4)
