#!/usr/bin/env python
"""Proof that the path tracer runs on an NVIDIA GPU, end to end.

    python chip_smoke.py            # one GPU: phases kernel..tests
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases, one result line each; any failure fails the script:

  kernel    the BVH traversal kernel, compiled for the card, against the
            plain jnp walk and the brute-force oracle on rays of the bench
            scene (81,922 triangles); then both timed on the bounce-0 and
            bounce-1 launches at bench width
  render    the production config (bench.py) at 512x512: the render step
            holds the kernel's custom call; image mean within 2% of the
            plain estimator (compact=False) and every 64x64 block within
            15%; heatmap mode; ms/sample, rays/s and compile seconds
  gradient  one parallel.dist.make_train_step step on a 1-device mesh
  refit     an on-device BVH refit against the host transform and rebuild
  tests     the `gpu`-marked tests, run by pytest in this process
  multi     (--multi only) the sharded render on 4 cards against the
            single-device Renderer per pixel, and the train step on 4
            cards against 1

The last line is one JSON object, printed only when every phase passed on
a GPU: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_SUBDIV = 6        # 81,922 triangles
BENCH_SIZE = 512
# kernel vs plain walk: |dt| <= 1e-5 t, |du|, |dv| <= 1e-5 (float32 with
# FMA contraction in either compiler; u, v lie in [0, 1]); a slot may
# differ only on a tie, where t agrees to 1e-6
T_RTOL, UV_ATOL, TIE_RTOL = 1e-5, 1e-5, 1e-6


def log(msg: str):
    print(msg, flush=True)


def sample_rays(scene, n: int, seed: int = 0):
    """n camera rays through random pixels of the 512x512 frame plus n
    rays from random points of the scene's box in random directions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fspt_tpu.core.camera import generate_rays
    from fspt_tpu.core.vec import V3
    from fspt_tpu.runtime.renderer import CameraState

    rng = np.random.default_rng(seed)
    cam = CameraState.from_config(scene.camera)
    px = jnp.asarray(rng.integers(0, BENCH_SIZE * BENCH_SIZE, n), jnp.int32)
    cam_u = jnp.asarray(rng.uniform(size=(4, n)), jnp.float32)
    o1, d1 = generate_rays(cam.position, cam.direction, cam.fov_scale,
                           cam.focal_depth, cam.aperture,
                           (BENCH_SIZE, BENCH_SIZE), cam_u, pixel_idx=px)
    lo = np.asarray(scene.arrays.node_min[0])
    hi = np.asarray(scene.arrays.node_max[0])
    o2 = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d2 = rng.normal(size=(n, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    cat = lambda a, b: jnp.concatenate([a, jnp.asarray(b)])
    origin = V3(cat(o1.x, o2[:, 0]), cat(o1.y, o2[:, 1]), cat(o1.z, o2[:, 2]))
    direction = V3(cat(d1.x, d2[:, 0]), cat(d1.y, d2[:, 1]),
                   cat(d1.z, d2[:, 2]))
    return jax.device_put(origin), jax.device_put(direction)


def compare_hits(got, ref, name: str, visits: bool = True) -> str:
    """Check got against ref within the tolerances above; returns a
    summary or raises AssertionError."""
    import numpy as np
    g = {f: np.asarray(getattr(got, f)) for f in got._fields}
    r = {f: np.asarray(getattr(ref, f)) for f in ref._fields}
    slot_diff = g["slot"] != r["slot"]
    tie_ok = np.abs(g["t"] - r["t"]) <= TIE_RTOL * np.abs(r["t"])
    bad_slot = int((slot_diff & ~tie_ok).sum())
    same = ~slot_diff & (r["slot"] >= 0)
    t_err = float(np.max(np.abs(g["t"] - r["t"])[same] / r["t"][same],
                         initial=0.0))
    uv_err = float(max(np.max(np.abs(g["u"] - r["u"])[same], initial=0.0),
                       np.max(np.abs(g["v"] - r["v"])[same], initial=0.0)))
    vis_bad = int((g["visits"] != r["visits"]).sum()) if visits else 0
    summary = (f"{name}: {len(g['t'])} rays, {int(same.sum())} hits, slot "
               f"ties {int(slot_diff.sum()) - bad_slot}, bad slots "
               f"{bad_slot}, max t rel err {t_err:.2e}, max uv err "
               f"{uv_err:.2e}, visits mismatches {vis_bad}")
    assert bad_slot == 0 and t_err <= T_RTOL and uv_err <= UV_ATOL, summary
    assert vis_bad == 0, summary
    return summary


def phase_kernel(scene, n_rays: int = 4096, interpret: bool = False):
    """Kernel vs plain walk vs brute-force oracle, nearest / any-hit /
    per-ray tmax."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fspt_tpu.core.traversal import intersect_scene_brute
    from fspt_tpu.ops import bvh

    a, m = scene.device_arrays(), scene.meta
    o, d = sample_rays(scene, n_rays)
    kw = dict(leaf_size=m.leaf_size, width=m.bvh_width,
              stack_depth=m.pk_stack_depth)
    kernel = jax.jit(lambda o, d, tm, any_hit: bvh.walk_kernel(
        a.pk_nodes, a.pk_leaves, o, d, tm, any_hit=any_hit,
        interpret=interpret, **kw), static_argnums=3)
    plain = jax.jit(lambda o, d, tm, any_hit: bvh.walk_plain(
        a.pk_nodes, a.pk_leaves, o, d, tm, any_hit=any_hit, **kw),
        static_argnums=3)
    n = o.x.shape[0]
    o3 = jnp.stack([o.x, o.y, o.z], -1)
    d3 = jnp.stack([d.x, d.y, d.z], -1)
    brute = intersect_scene_brute(a, o3, d3)
    brute = bvh.PacketHit(t=brute.t, slot=brute.slot, u=jnp.zeros(n),
                          v=jnp.zeros(n), visits=brute.visits)
    rng = np.random.default_rng(1)
    clip = jnp.asarray(rng.uniform(0.05, 2.0, n), jnp.float32)
    full = jnp.full((n,), bvh.MAX_T, jnp.float32)
    lines = []
    t0 = time.perf_counter()
    hk = kernel(o, d, full, False)
    jax.block_until_ready(hk)
    lines.append(f"kernel compile+run {time.perf_counter() - t0:.2f} s")
    hp = plain(o, d, full, False)
    lines.append(compare_hits(hk, hp, "nearest kernel vs plain"))
    # the oracle returns no barycentrics or visits: compare slot and t
    hk_b = hk._replace(u=jnp.zeros(n), v=jnp.zeros(n))
    lines.append(compare_hits(hk_b, brute, "nearest kernel vs brute",
                              visits=False))
    ck, cp = kernel(o, d, clip, False), plain(o, d, clip, False)
    lines.append(compare_hits(ck, cp, "tmax kernel vs plain"))
    bs, bt = np.asarray(brute.slot), np.asarray(brute.t)
    want = np.where(bt < np.asarray(clip), bs, -1)
    miss = np.asarray(ck.slot) < 0
    assert np.array_equal(miss, want < 0), "tmax: hit/miss vs brute"
    assert np.array_equal(np.asarray(ck.t)[miss], np.asarray(clip)[miss]), \
        "tmax: misses must keep t == tmax"
    ak, ap = kernel(o, d, full, True), plain(o, d, full, True)
    occ_k = np.asarray(ak.slot) >= 0
    assert np.array_equal(occ_k, np.asarray(ap.slot) >= 0), "any-hit vs plain"
    assert np.array_equal(occ_k, bs >= 0), "any-hit vs brute"
    assert np.array_equal(np.asarray(ak.visits), np.asarray(ap.visits)), \
        "any-hit visits vs plain"
    lines.append(f"any-hit: {int(occ_k.sum())} occluded of {n}, equal to "
                 f"plain and brute; visits equal")
    return lines


def bounce1_rays(scene, cfg, origin, direction, hit, key):
    """The bounce-1 launch the integrator makes after bounce 0: diffuse
    scatter rays and env-bin shadow rays from the primary hits (parked
    where the primary missed), concatenated and in Morton order of the
    hit points, as cfg.sort_state leaves them."""
    import jax
    import jax.numpy as jnp

    from fspt_tpu.core import brdf, vec
    from fspt_tpu.core.env import sample_env_bins
    from fspt_tpu.core.integrator import _morton21
    from fspt_tpu.core.vec import V3

    a, m = scene.device_arrays(), scene.meta
    n = origin.x.shape[0]
    active = hit.slot >= 0
    s = jnp.maximum(hit.slot, 0)
    e1 = V3(*a.tri_e1[s].T)
    e2 = V3(*a.tri_e2[s].T)
    nrm = vec.normalize(vec.cross(e1, e2))
    nrm = vec.where(vec.dot(nrm, direction) > 0.0, -nrm, nrm)
    p = origin + direction * hit.t + nrm * (cfg.epsilon * 2.0)
    u = jax.random.uniform(key, (5, n))
    scat = brdf.sample_lambert(nrm, u[0], u[1])
    bins4 = jnp.stack([a.bin_x0, a.bin_y0, a.bin_x1, a.bin_y1], -1)
    env_dir, _ = sample_env_bins(bins4, a.n_bins, (m.env_h, m.env_w),
                                 a.env_theta, u[2], u[3], u[4])
    shadow = active & (vec.dot(nrm, env_dir) > 0.0)
    wmin = a.node_min[0]
    ext = jnp.maximum(a.node_max[0] - wmin, 1e-6)
    key_m = jnp.where(active, _morton21((p.x - wmin[0]) / ext[0],
                                        (p.y - wmin[1]) / ext[1],
                                        (p.z - wmin[2]) / ext[2]), 1 << 30)
    perm = jnp.argsort(key_m)
    park = vec.splat(1.0e9, like=p.x)
    up = V3(jnp.zeros(n), jnp.ones(n), jnp.zeros(n))
    so, sd = vec.where(active, p, park), vec.where(active, scat, up)
    ho, hd = vec.where(shadow, p, park), vec.where(shadow, env_dir, up)
    tm = jnp.concatenate([jnp.full((n,), cfg.max_t),
                          jnp.where(shadow, cfg.max_t, 0.0)])[
        jnp.concatenate([perm, perm + n])]
    cat = lambda f: jnp.concatenate([f(so)[perm], f(ho)[perm]])
    catd = lambda f: jnp.concatenate([f(sd)[perm], f(hd)[perm]])
    o1 = V3(cat(lambda v: v.x), cat(lambda v: v.y), cat(lambda v: v.z))
    d1 = V3(catd(lambda v: v.x), catd(lambda v: v.y), catd(lambda v: v.z))
    return o1, d1, tm


def time_call(fn, *args, reps: int = 5) -> float:
    """Median wall ms of fn(*args), each call ended in block_until_ready
    (compiled and warmed first)."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def kernel_timing(scene, size: int = BENCH_SIZE, interpret: bool = False,
                  reps: int = 5, card: str = ""):
    """Kernel vs plain walk on the bench launches: bounce 0 (size^2
    primary rays in tile order) and bounce 1 (scatter + shadow rays from
    those hits).  Turns: kernel, plain, plain, kernel."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fspt_tpu.core.camera import generate_rays
    from fspt_tpu.ops import bvh
    from fspt_tpu.runtime.layout import tile_order
    from fspt_tpu.runtime.renderer import CameraState

    from bench import bench_config
    cfg = bench_config(size)
    a, m = scene.device_arrays(), scene.meta
    cam = CameraState.from_config(scene.camera)
    n = size * size
    px = jnp.asarray(tile_order(size, size), jnp.int32)
    o, d = generate_rays(cam.position, cam.direction, cam.fov_scale,
                         cam.focal_depth, cam.aperture, (size, size),
                         jnp.full((4, n), 0.5, jnp.float32), pixel_idx=px)
    kw = dict(leaf_size=m.leaf_size, width=m.bvh_width,
              stack_depth=m.pk_stack_depth)
    impls = {
        "kernel": jax.jit(lambda o, d, tm: bvh.walk_kernel(
            a.pk_nodes, a.pk_leaves, o, d, tm, interpret=interpret, **kw)),
        "plain": jax.jit(lambda o, d, tm: bvh.walk_plain(
            a.pk_nodes, a.pk_leaves, o, d, tm, **kw)),
    }
    full = jnp.full((n,), bvh.MAX_T, jnp.float32)
    hit0 = impls["plain"](o, d, full)
    o1, d1, tm1 = bounce1_rays(scene, cfg, o, d, hit0, jax.random.key(0))
    launches = {"bounce0": (o, d, full), "bounce1": (o1, d1, tm1)}
    out = []
    for lname, args in launches.items():
        ms = {"kernel": [], "plain": []}
        for impl in ("kernel", "plain", "plain", "kernel"):
            ms[impl].append(time_call(impls[impl], *args, reps=reps))
        vis = np.asarray(impls["kernel"](*args).visits)
        out.append(f"{lname}: {args[0].x.shape[0]} rays, kernel "
                   f"{np.mean(ms['kernel']):.3f} ms ({ms['kernel']}), plain "
                   f"{np.mean(ms['plain']):.3f} ms ({ms['plain']}), "
                   f"mean visits {vis.mean():.2f}, max {vis.max()}; "
                   f"card: {card}")
    return out


def lowered_step(r):
    """The renderer's jitted sample step, lowered for its device."""
    return r._step.lower(r.arrays, cam=r.camera, accum=r.accum,
                         count=r.count, rays=r.rays, base_key=r.base_key,
                         sample_idx=r.sample_idx, pixel_idx=r.pixel_idx)


def phase_render(scene, size: int = BENCH_SIZE, spp: int = 8,
                 steps: int = 2, expect_kernel: bool = True, card: str = ""):
    """Production config vs the plain estimator, heatmap mode, timing."""
    import dataclasses

    import numpy as np

    from fspt_tpu.config import RenderConfig
    from fspt_tpu.runtime.renderer import Renderer

    from bench import bench_config
    cfg = bench_config(size, spp)
    lines = []
    r = Renderer(scene, cfg)
    lowered = lowered_step(r)
    hlo = lowered.as_text()
    has_kernel = "bvh_walk" in hlo and "triton" in hlo
    assert has_kernel == expect_kernel, (
        f"render step {'lacks' if expect_kernel else 'holds'} the kernel")
    lines.append(f"render step holds the traversal kernel's custom call: "
                 f"{has_kernel}")
    t0 = time.perf_counter()
    compiled = lowered.compile()
    lines.append(f"render step compile {time.perf_counter() - t0:.1f} s "
                 f"(card: {card}); "
                 f"memory_analysis: {compiled.memory_analysis()}")
    t0 = time.perf_counter()
    r.step()
    compile_s = time.perf_counter() - t0
    r._stats = {"samples": 0, "seconds": 0.0, "rays": 0.0}
    r.step(steps)
    st = r.stats
    prod = r.hdr_image()
    assert np.isfinite(prod).all(), "production image not finite"

    plain_cfg = RenderConfig(width=size, height=size, bounces=cfg.bounces,
                             extra_refraction_iters=0, batch_spp=spp)
    rp = Renderer(scene, plain_cfg)
    rp.step(steps + 1)
    ref = rp.hdr_image()
    assert np.isfinite(ref).all(), "plain-estimator image not finite"
    mean_rel = abs(prod.mean() - ref.mean()) / ref.mean()
    b = max(size // 8, 1)
    blocks = lambda x: x.reshape(size // b, b, size // b, b, 3).mean(
        axis=(1, 3, 4))
    block_rel = float(np.max(np.abs(blocks(prod) - blocks(ref))
                             / np.maximum(blocks(ref), 1e-2)))
    lines.append(f"image vs plain estimator: mean rel diff {mean_rel:.4f} "
                 f"(limit 0.02), worst {b}x{b} block {block_rel:.4f} "
                 f"(limit 0.15)")
    assert mean_rel < 0.02 and block_rel < 0.15, lines[-1]

    rh = Renderer(scene, dataclasses.replace(plain_cfg, mode="bvh_heatmap",
                                             batch_spp=1))
    heat = rh.step().hdr_image()
    assert np.isfinite(heat).all() and heat.max() > 0, "heatmap is zero"
    lines.append(f"heatmap: mean visits/pixel "
                 f"{heat.mean() / plain_cfg.heatmap_scale:.2f}")
    lines.append(f"production {size}x{size}, {spp} spp/step: "
                 f"{st['seconds'] / st['samples'] * 1e3:.3f} ms/sample, "
                 f"{st['rays_per_s']:.4g} rays/s, first step (compile + "
                 f"run) {compile_s:.1f} s; card: {card}")
    return lines


def _fits(compiled, device) -> tuple:
    m = compiled.memory_analysis()
    need = (m.temp_size_in_bytes + m.argument_size_in_bytes
            + m.output_size_in_bytes)
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    return (limit is None or need <= limit), need, limit


def phase_gradient(scene, size: int = BENCH_SIZE, bounces: int = 4):
    """One train step on a 1-device mesh; halves the square image while
    memory_analysis says the step does not fit."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fspt_tpu.config import RenderConfig
    from fspt_tpu.parallel.dist import (make_mesh, make_train_step,
                                        shard_accum, split_params)
    from fspt_tpu.runtime.renderer import CameraState

    mesh = make_mesh(1)
    arrays = scene.device_arrays()
    cam = CameraState.from_config(scene.camera)
    params = split_params(arrays)
    cam_params = {"position": cam.position, "direction": cam.direction}
    lines = []
    s = size
    while True:
        cfg = RenderConfig(width=s, height=s, bounces=bounces,
                           extra_refraction_iters=0, batch_spp=1)
        train = jax.jit(make_train_step(mesh, cfg, scene.meta))
        target = shard_accum(jnp.full((3, s * s), 0.25, jnp.float32), mesh)
        args = (params, cam_params, arrays, cam, target, jax.random.key(1), 0)
        compiled = train.lower(*args).compile()
        ok, need, limit = _fits(compiled, jax.devices()[0])
        lines.append(f"train step {s}x{s}: needs {need / 2**30:.2f} GiB, "
                     f"device limit "
                     f"{'unknown' if limit is None else f'{limit / 2**30:.2f} GiB'}")
        if ok or s <= 16:
            break
        s //= 2
    if s != size:
        lines.append(f"{size}x{size} does not fit; ran {s}x{s}")
    loss, grads, cam_grads = train(*args)
    flat = jax.tree.leaves((grads, cam_grads))
    finite = np.isfinite(float(loss)) and all(
        np.isfinite(np.asarray(g)).all() for g in flat)
    total = sum(float(jnp.sum(jnp.abs(g))) for g in flat)
    lines.append(f"loss {float(loss):.6g}, gradients finite {finite}, "
                 f"sum |grad| {total:.4g}")
    assert finite and total > 0, lines[-1]
    return lines


def phase_refit(subdivisions: int = 5):
    """Refit on the device vs the host: triangles against a float64
    transform of the base frame, and the root box against a host rebuild
    of the moved frame."""
    import numpy as np

    from fspt_tpu.scene.refit import (build_refit_aux, delta_affines,
                                      refit_arrays)
    from fspt_tpu.scene.schema import (_prop_defaults, load_scene_dict,
                                       merge_scene_props)
    from fspt_tpu.testing import DictAssetLoader, icosphere_obj, quad_obj

    def scene_dict(translate, angle):
        return {
            "environment": [[0.2, 0.2, 0.3], [0.8, 0.9, 1.0]],
            "props": [{"path": "floor.obj", "scale": 6.0,
                       "translate": [0, -0.5, 0], "normals": "flat"}],
            "animated_props": [{
                "path": "sphere.obj", "scale": 0.4, "translate": translate,
                "rotate": [{"axis": [0, 1, 0], "angle": angle}],
                "normals": "smooth"}],
        }

    loader = DictAssetLoader(texts={"sphere.obj": icosphere_obj(subdivisions),
                                    "floor.obj": quad_obj()})
    base_sd = scene_dict([0.0, 0.0, 0.0], 0.0)
    moved_sd = scene_dict([0.35, 0.15, -0.2], 0.8)
    base = load_scene_dict(base_sd, loader)
    moved = load_scene_dict(moved_sd, loader)
    aux = build_refit_aux(base)
    mats, trans = delta_affines(
        [_prop_defaults(p) for p in merge_scene_props(base_sd)],
        [_prop_defaults(p) for p in merge_scene_props(moved_sd)])
    out = refit_arrays(base.device_arrays(), base.meta, aux, mats, trans)

    pid = np.asarray(aux.slot_prop)
    valid = np.asarray(aux.slot_valid)[:, None]
    M = np.asarray(mats, np.float64)[pid]
    T = np.asarray(trans, np.float64)[pid]
    v0 = np.asarray(base.arrays.tri_v0, np.float64)
    want_v0 = np.where(valid, np.einsum("sij,sj->si", M, v0) + T, 0.0)
    err_v0 = float(np.max(np.abs(np.asarray(out.tri_v0) - want_v0)))
    root = np.concatenate([np.asarray(out.node_min[0]),
                           np.asarray(out.node_max[0])])
    want_root = np.concatenate([moved.arrays.node_min[0],
                                moved.arrays.node_max[0]])
    err_root = float(np.max(np.abs(root - want_root)))
    line = (f"refit of {base.num_triangles} triangles: max vertex error "
            f"{err_v0:.2e} vs float64 host transform, max root-box error "
            f"{err_root:.2e} vs host rebuild (limit 1e-5; TF32 would be "
            f"~1e-3)")
    assert err_v0 < 1e-5 and err_root < 1e-5, line
    return [line]


def phase_gpu_tests():
    """The gpu-marked tests, in this process (one JAX process per card)."""
    import pytest
    os.environ["FSPT_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    assert rc == 0, f"pytest -m gpu exited {rc}"
    return [f"pytest -m gpu: exit {rc}"]


def phase_multi(scene, size: int = BENCH_SIZE, n_dev: int = 4,
                spp: int = 8, train_size: int = 256):
    """Sharded render on n_dev devices vs the single-device Renderer, per
    pixel; train step on n_dev devices vs 1."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fspt_tpu.config import RenderConfig
    from fspt_tpu.parallel.dist import (make_mesh, make_sharded_sample_step,
                                        make_train_step, shard_accum,
                                        split_params)
    from fspt_tpu.runtime.renderer import CameraState, Renderer

    from bench import bench_config
    assert len(jax.devices()) >= n_dev, f"needs {n_dev} devices"
    # bench settings with the default compaction schedule, which keeps
    # Russian roulette from firing (rr_lanes), so shards and the single
    # device trace the same estimator lane for lane
    cfg = dataclasses.replace(bench_config(size, spp),
                              compact_schedule=RenderConfig.compact_schedule,
                              wavefront_batch=False)
    arrays = scene.device_arrays()
    cam = CameraState.from_config(scene.camera)
    n = size * size
    mesh = make_mesh(n_dev)
    step = make_sharded_sample_step(mesh, cfg, scene.meta)
    accum = shard_accum(jnp.zeros((3, n), jnp.float32), mesh)
    count = jnp.zeros(())
    key = jax.random.key(cfg.seed)
    accum, count, shard_rays = step(arrays, cam, accum, count, key, 0)
    sharded = np.asarray(accum) / float(count)
    r = Renderer(scene, cfg)
    r.step(1)
    single = np.asarray(r.accum) / float(r.count)
    img_sh = np.zeros_like(sharded)
    img_sh[:, step.pixel_order] = sharded
    img_1 = np.zeros_like(single)
    img_1[:, np.asarray(r.pixel_idx)] = single
    err = np.abs(img_sh - img_1)
    bad = int((err > 1e-5 + 1e-5 * np.abs(img_1)).sum())
    lines = [f"sharded render {size}x{size} on {n_dev} devices vs 1: "
             f"{bad} of {img_1.size} values differ beyond 1e-5 (max "
             f"{err.max():.2e}); rays per shard "
             f"{np.asarray(shard_rays).tolist()}"]
    assert np.isfinite(sharded).all() and bad == 0, lines[-1]

    tcfg = RenderConfig(width=train_size, height=train_size, bounces=4,
                        extra_refraction_iters=0, batch_spp=1)
    params = split_params(arrays)
    cam_params = {"position": cam.position, "direction": cam.direction}
    outs = {}
    for nd in (n_dev, 1):
        m = make_mesh(nd)
        train = make_train_step(m, tcfg, scene.meta)
        target = shard_accum(jnp.full((3, train_size ** 2), 0.25,
                                      jnp.float32), m)
        outs[nd] = jax.device_get(train(params, cam_params, arrays, cam,
                                        target, jax.random.key(1), 0))
    (l4, g4, c4), (l1, g1, c1) = outs[n_dev], outs[1]
    loss_rel = abs(float(l4) - float(l1)) / abs(float(l1))
    worst = 0.0
    for a4, a1 in zip(jax.tree.leaves((g4, c4)), jax.tree.leaves((g1, c1))):
        scale = max(float(np.max(np.abs(a1))), 1e-30)
        worst = max(worst, float(np.max(np.abs(a4 - a1))) / scale)
    # the two differ only in summation order: shard means of 1/n_dev of
    # the pixels, then pmean, against one mean over all of them
    lines.append(f"train step {train_size}x{train_size} on {n_dev} devices "
                 f"vs 1: loss rel diff {loss_rel:.2e} (limit 1e-5), worst "
                 f"grad diff / max|grad| {worst:.2e} (limit 1e-3)")
    assert loss_rel < 1e-5 and worst < 1e-3, lines[-1]
    return lines


def run_phase(name, fn, *args, **kwargs) -> bool:
    t0 = time.perf_counter()
    try:
        lines = fn(*args, **kwargs)
    except Exception:     # a failed phase fails the run; the rest still run
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        traceback.print_exc()
        sys.stdout.flush()
        return False
    for line in lines:
        log(f"[{name}] {line}")
    log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    multi = "--multi" in argv
    from bench import card_name_and_power_limit
    card = card_name_and_power_limit()      # before JAX takes the card
    import jax
    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(f"device: {device}")
    if device["platform"] != "gpu":
        log("chip_smoke.py needs a GPU; JAX found none")
        return 1
    from fspt_tpu.compile_cache import use_compile_cache
    from fspt_tpu.testing import make_bunny_standin_scene
    use_compile_cache()
    t0 = time.perf_counter()
    scene = make_bunny_standin_scene(subdivisions=BENCH_SUBDIV)
    log(f"bench scene: {scene.num_triangles} triangles, wide-BVH depth "
        f"{scene.meta.pk_stack_depth // scene.meta.bvh_width - 2}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    if multi:
        ok = run_phase("multi", phase_multi, scene)
    else:
        ok = all([run_phase("kernel", phase_kernel, scene),
                  run_phase("kernel", kernel_timing, scene, card=card),
                  run_phase("render", phase_render, scene, card=card),
                  run_phase("gradient", phase_gradient, scene),
                  run_phase("refit", phase_refit),
                  run_phase("tests", phase_gpu_tests)])
    log(f"card: {card}")
    if not ok:
        log("chip_smoke: a phase failed")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
