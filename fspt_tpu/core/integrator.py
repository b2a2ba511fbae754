"""The path-tracing integrator: a vectorized, differentiable re-design of the
reference's GLSL megakernel (reference shader/tracer.fs:436-518).

Estimator parity (same math, same sampling strategies, same MIS):
  * primary ray from camera textures -> here passed-in SoA ray batch
  * primary miss adds unweighted environment radiance (tracer.fs:442-443)
  * per shading iteration: barycentric hit attributes, atlas fetches
    (diffuse/emissive/metallicRoughness/normal), tangent-space normal mapping
    (tracer.fs:447-460), inside/IOR determination (:461-463), emissive add
    throughput * texEmissive * texDiffuse * emissive_scale (:467),
    lobe select by Schlick-Fresnel/metallic mix vs uniform (:475):
      - specular: GGX half-vector sample, reflect, GTR2 pdf (:476-480)
      - refraction when dielectric >= 0: pdf 1, does NOT consume a bounce
        (:481-488 — the GLSL `i--`), Beer's-law absorption when inside (:497)
      - diffuse: cosine hemisphere (:489-493)
    environment NEE with one bin-sampled env direction + shadow ray and
    power-heuristic MIS (:499-512); radiance clamp (:515).

Re-design vs the reference:
  * everything is SoA: rays, normals, colors are V3 of flat (N,) planes;
    per-hit attributes come from row gathers of flat tables
  * the bounce loop is a lax.scan with per-lane active masks and bounce
    budgets (refraction chains get `extra_refraction_iters` extra segments)
  * nearest-hit scatter rays and any-hit shadow rays run through the wide
    BVH traversal (ops/bvh.py), which also returns hit barycentrics —
    triangle vertices are never re-fetched for shading
  * counter-based RNG (core/rng.py) instead of fract(sin()) hashes
  * fully differentiable w.r.t. materials, atlas, env map, and camera:
    discrete events (hit selection, lobe choice, bin pick) are detached via
    stop_gradient; continuous factors carry gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fspt_tpu.config import RenderConfig
from fspt_tpu.core import brdf
from fspt_tpu.core import vec
from fspt_tpu.core.env import (env_radiance, env_radiance_rows,
                               env_radiance_rows_nearest, pack_env_rows,
                               sample_env_bins, sample_env_bins_radiance)
from fspt_tpu.core import rng
from fspt_tpu.core.rng import stream_uniforms
from fspt_tpu.core.vec import V3, dot, normalize, where
from fspt_tpu.ops.bvh import PacketHit, traverse

sg = jax.lax.stop_gradient


def intersect(scene, cfg: RenderConfig, meta, origin: V3, direction: V3,
              tmax=None, any_hit: bool = False) -> PacketHit:
    """Nearest-hit (or any-hit) traversal, non-differentiable by design:
    the hit event is a discrete decision (SURVEY §7.1), so traversal inputs
    are detached and shading re-derives differentiable quantities."""
    if cfg.intersector == "brute":
        return _intersect_brute(scene, cfg, origin, direction, tmax=tmax)
    return traverse(scene.pk_nodes, scene.pk_leaves, sg(origin),
                    sg(direction), sg(tmax) if tmax is not None else None,
                    leaf_size=meta.leaf_size, width=meta.bvh_width,
                    any_hit=any_hit, stack_depth=meta.pk_stack_depth,
                    plain=cfg.intersector == "plain")


def _morton21(x, y, z):
    """21-bit Morton code from three [0,1) floats (7 bits/axis)."""
    def q(a):
        return jnp.clip((a * 128.0).astype(jnp.int32), 0, 127)
    qx, qy, qz = q(x), q(y), q(z)
    code = jnp.zeros_like(qx)
    for b in range(7):
        code = (code
                | (((qx >> b) & 1) << (3 * b + 2))
                | (((qy >> b) & 1) << (3 * b + 1))
                | (((qz >> b) & 1) << (3 * b)))
    return code


def sorted_intersect(scene, cfg: RenderConfig, meta, origin: V3,
                     direction: V3, active, tmax=None,
                     any_hit: bool = False) -> PacketHit:
    """Traversal with coherence sorting (secondary rays).

    Post-bounce directions are hemisphere-random; sorting by (Morton code
    of the origin within the scene bounds, direction octant) puts rays
    that walk similar BVH paths next to each other, so neighbouring lanes
    fetch the same rows; inactive lanes are keyed last.  Key order is
    position-first (morton<<3 | octant).  One lax.sort over [key, lane-id]
    plus one row gather and one inverse row scatter.  What the sort is
    worth on the GPU is not measured yet."""
    if (cfg.intersector == "brute" or not cfg.sort_rays
            or cfg.sort_state):
        # sort_state: the path state was already permuted into Morton
        # order this iteration (_sort_state), so launches go out unsorted
        # and hits come back aligned — no inverse scatter
        return intersect(scene, cfg, meta, origin, direction, tmax=tmax,
                         any_hit=any_hit)
    n = origin.x.shape[0]
    octant = ((direction.x < 0).astype(jnp.int32) * 4
              + (direction.y < 0).astype(jnp.int32) * 2
              + (direction.z < 0).astype(jnp.int32))
    # normalize origins to the root AABB (dynamic values are fine here)
    wmin = scene.node_min[0]
    extent = jnp.maximum(scene.node_max[0] - wmin, 1e-6)
    morton = _morton21((origin.x - wmin[0]) / extent[0],
                       (origin.y - wmin[1]) / extent[1],
                       (origin.z - wmin[2]) / extent[2])
    key = jnp.where(active, (morton << 3) | octant, jnp.int32(1) << 30)
    lane = jnp.arange(n, dtype=jnp.int32)
    if tmax is None:
        tmax = jnp.full((n,), cfg.max_t, jnp.float32)
    # Sort only (key, lane) and move the 7 ray planes with ONE (N, 7) row
    # gather; un-permute the 5 hit planes with ONE row scatter.  slot/visits
    # ride the f32 rows exactly (values < 2^24).
    _, perm = jax.lax.sort((sg(key), lane), num_keys=2, is_stable=False)
    rays = sg(jnp.stack([origin.x, origin.y, origin.z, direction.x,
                         direction.y, direction.z, tmax], axis=-1))[perm]
    hit = intersect(scene, cfg, meta,
                    V3(rays[:, 0], rays[:, 1], rays[:, 2]),
                    V3(rays[:, 3], rays[:, 4], rays[:, 5]),
                    tmax=rays[:, 6], any_hit=any_hit)
    packed = jnp.stack([hit.t, hit.slot.astype(jnp.float32), hit.u, hit.v,
                        hit.visits.astype(jnp.float32)], axis=-1)
    out = jnp.zeros_like(packed).at[perm].set(packed, unique_indices=True,
                                              mode="promise_in_bounds")
    return PacketHit(t=out[:, 0], slot=out[:, 1].astype(jnp.int32),
                     u=out[:, 2], v=out[:, 3],
                     visits=out[:, 4].astype(jnp.int32))


def _intersect_brute(scene, cfg, origin: V3, direction: V3,
                     tmax=None) -> PacketHit:
    """O(N*T) oracle path (cfg.intersector='brute', tests only)."""
    from fspt_tpu.core.geometry import brute_force_intersect
    o = sg(vec.to_array(origin))
    d = sg(vec.to_array(direction))
    t, slot = brute_force_intersect(o, d, scene.tri_v0, scene.tri_e1,
                                    scene.tri_e2, max_t=cfg.max_t)
    if tmax is not None:
        # honor the per-ray clip like the Pallas kernels (t_init = tmax,
        # hits require t < tmax): without this, light-NEE shadow rays
        # (tmax = light distance * (1 - 1e-3)) self-block on the light
        # they sample and l_nee silently never contributes in brute mode
        tmax = sg(tmax)
        hit_ok = t < tmax
        slot = jnp.where(hit_ok, slot, -1)
        t = jnp.where(hit_ok, t, tmax)
    gi = jnp.maximum(slot, 0)
    v0 = scene.tri_v0[gi]
    e1 = scene.tri_e1[gi]
    e2 = scene.tri_e2[gi]
    p = o + d * t[:, None]
    # barycentrics of the hit (u weights corner1, v weights corner2)
    v2 = p - v0
    d00 = jnp.sum(e1 * e1, -1)
    d01 = jnp.sum(e1 * e2, -1)
    d11 = jnp.sum(e2 * e2, -1)
    d20 = jnp.sum(v2 * e1, -1)
    d21 = jnp.sum(v2 * e2, -1)
    den = d00 * d11 - d01 * d01
    inv = jnp.reciprocal(jnp.where(jnp.abs(den) > 1e-20, den, 1.0))
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    return PacketHit(t=t, slot=slot, u=u, v=v,
                     visits=jnp.zeros_like(slot))


def atlas_fetch_rgb(scene, meta, layer, u, v, rows=None) -> V3:
    """Bilinear RGB fetch from the flat atlas channel planes with REPEAT
    wrap; v=0 maps to the image bottom row (OBJ/GL convention).
    layer: (N,) i32; u/v: (N,). Returns V3 of (N,).
    rows: optional pre-stacked (M, 3) RGB table (trace_paths builds it once
    outside the bounce scan rather than relying on XLA loop-invariant
    hoisting of a materialized buffer)."""
    r = meta.atlas_res
    x = u * r - 0.5
    y = (1.0 - v) * r - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.mod(x0f.astype(jnp.int32), r)
    x1 = jnp.mod(x0 + 1, r)
    y0 = jnp.mod(y0f.astype(jnp.int32), r)
    y1 = jnp.mod(y0 + 1, r)
    base = layer * (r * r)
    i00 = base + y0 * r + x0
    i10 = base + y0 * r + x1
    i01 = base + y1 * r + x0
    i11 = base + y1 * r + x1
    fx = fx[:, None]
    fy = fy[:, None]

    # One (N, 3) row gather per corner instead of 3 scalar-plane gathers;
    # x-lerp then y-lerp, the association atlas_fetch_all uses, so the
    # packed and per-map paths agree to the bit
    if rows is None:
        rows = jnp.stack([scene.atlas_r, scene.atlas_g, scene.atlas_b],
                         axis=-1)
    top = rows[i00] * (1 - fx) + rows[i10] * fx
    bot = rows[i01] * (1 - fx) + rows[i11] * fx
    out = top * (1 - fy) + bot * fy
    return V3(out[:, 0], out[:, 1], out[:, 2])


class TexTables(NamedTuple):
    """Loop-invariant texture tables, built once per traced sample.

    The shading hot path packs everything a shading point needs into as few
    row gathers as possible (what that is worth on the GPU against more,
    narrower gathers is not measured yet):

      mat_tex: (U*R*R, 24) — all four material maps (diffuse, emissive,
          normal, metallicRoughness = 12 channels) of each combined
          material (scene.map_c / scene.mat_layers), plus the x-neighbor
          texel's 12 channels.  A full bilinear fetch of all four maps is
          then 2 gathers (y0 row, y1 row) instead of 16.  None when the
          packed table would exceed the memory guard — the per-map
          atlas_rows fallback path is used instead.
      env6: (H*W, 6) — x-neighbor-packed environment map
          (core/env.pack_env_rows): bilinear env radiance in 2 gathers.
      bins4: (B, 4) — env importance bins as rows: 1 gather per sample.
      atlas_rows: (L*R*R, 3) — fallback per-map table (also the table the
          heatmap/abridged paths use).
    """

    mat_tex: jnp.ndarray
    env6: jnp.ndarray
    bins4: jnp.ndarray
    atlas_rows: jnp.ndarray


# Packed-material-table memory guard: combined (U, R, R, 24) f32 texels.
# Above this, fall back to per-map fetches instead of materializing a
# multi-GiB table in HBM.
_MAT_TEX_BUDGET_BYTES = 2 * 1024 ** 3


def _packed_tables(scene, cfg: RenderConfig, meta) -> TexTables:
    atlas_rows = jnp.stack([scene.atlas_r, scene.atlas_g, scene.atlas_b],
                           axis=-1)
    r = meta.atlas_res
    n_mat = scene.mat_layers.shape[0]
    mat_tex = None
    if cfg.packed_textures and n_mat * r * r * 24 * 4 <= _MAT_TEX_BUDGET_BYTES:
        layers = atlas_rows.reshape(meta.atlas_layers, r, r, 3)
        combo = jnp.concatenate(
            [layers[scene.mat_layers[:, k]] for k in range(4)], axis=-1)
        nxt = jnp.roll(combo, -1, axis=2)          # x-neighbor, REPEAT wrap
        mat_tex = jnp.concatenate([combo, nxt],
                                  axis=-1).reshape(n_mat * r * r, 24)
    env6 = pack_env_rows(scene.env_rgb, (meta.env_h, meta.env_w))
    bins4 = jnp.stack([scene.bin_x0, scene.bin_y0, scene.bin_x1,
                       scene.bin_y1], axis=-1)
    return TexTables(mat_tex=mat_tex, env6=env6, bins4=bins4,
                     atlas_rows=atlas_rows)


def atlas_fetch_all(mat_tex, meta, map_c, u, v):
    """Bilinear fetch of all four material maps at once from the packed
    (U*R*R, 24) table: 2 row gathers.  Same REPEAT wrap / v-flip semantics
    as atlas_fetch_rgb.  Returns (diffuse, emissive, normal_rgb, mr)."""
    r = meta.atlas_res
    x = u * r - 0.5
    y = (1.0 - v) * r - 0.5
    x0f, y0f = jnp.floor(x), jnp.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = jnp.mod(x0f.astype(jnp.int32), r)
    y0 = jnp.mod(y0f.astype(jnp.int32), r)
    y1 = jnp.mod(y0 + 1, r)
    base = map_c * (r * r)
    r0 = mat_tex[base + y0 * r + x0]
    r1 = mat_tex[base + y1 * r + x0]
    top = r0[:, 0:12] * (1 - fx) + r0[:, 12:24] * fx
    bot = r1[:, 0:12] * (1 - fx) + r1[:, 12:24] * fx
    out = top * (1 - fy) + bot * fy
    c3 = lambda i: V3(out[:, i], out[:, i + 1], out[:, i + 2])
    return c3(0), c3(3), c3(6), c3(9)


class PathState(NamedTuple):
    origin: V3                 # (W,) planes
    direction: V3
    t: jnp.ndarray             # (W,) current-hit distance
    slot: jnp.ndarray          # (W,) current-hit slot (-1 miss)
    bu: jnp.ndarray            # (W,) hit barycentric (corner 1)
    bv: jnp.ndarray            # (W,) hit barycentric (corner 2)
    throughput: V3
    color: V3                  # radiance accumulated along this lane's
                               # path so far (deposited once, at trace
                               # end or when the lane is compacted away)
    bounces_used: jnp.ndarray  # (W,) i32
    active: jnp.ndarray        # (W,) bool
    prev_pdf: jnp.ndarray      # (W,) solid-angle pdf of the ray that
                               # produced this hit (for emissive-hit MIS
                               # when light NEE is on; huge => weight 1)
    lidx: jnp.ndarray          # (W,) i32 — local lane (framebuffer index)
    gid: jnp.ndarray           # (W,) i32 — global RNG lane id (core/rng.py)


class TraceStats(NamedTuple):
    """Per-sample observability (SURVEY §5 metrics).

    rays counts *active lanes only* — the honest "rays actually traced"
    figure (primary + per-iteration live scatter/shadow segments), NOT the
    2N-lanes-per-launch upper bound.
    """

    rays: jnp.ndarray          # () f32 — active-lane rays traced
    active: jnp.ndarray       # (max_iters,) f32 — live scatter lanes per it
    shadow: jnp.ndarray       # (max_iters,) f32 — live shadow lanes per it
    visits: jnp.ndarray       # (max_iters,) f32 — summed node visits / lane
    rr_lanes: jnp.ndarray      # () f32 — active lanes dropped (and RR-
    #                            reweighted) across all compactions; > 0
    #                            iff Russian roulette actually fired


# RNG stream id base for compaction survivor selection (streams 1..max_iters
# are the shading streams; keep a gap above any plausible max_iters)
_RR_STREAM = 64


def _compact(state: PathState, key, it: int, w_out: int,
             key_rows=None, lanes_per_key: int = 0,
             stream_base: int = _RR_STREAM):
    """Shrink the path state to `w_out` lanes, unbiasedly.

    XLA shapes are static, so "trace only the live rays" cannot be a
    dynamic-size launch.  Instead the state is *statically* re-bucketed:
    the survivors are a uniform random min(A, w_out)-subset of the A active lanes (smallest per-lane RNG key
    wins), and every survivor's throughput is scaled by A / w_out when
    A > w_out — classic Russian-roulette reweighting, so the estimator
    stays unbiased no matter how aggressive the schedule is.  When
    A <= w_out (the common case with the default schedule) the selection
    keeps every active lane with weight 1 and the estimator is unchanged
    lane-for-lane, because all per-lane randomness is keyed by the global
    lane id (core/rng.py), not by buffer position.

    Radiance deposits are DEFERRED: survivors keep their accumulated
    color, and the dropped lanes' (lidx, color) rows come back densely (a
    complement gather, no scatter) for the caller to write in ONE
    end-of-trace scatter where every framebuffer lane is set exactly once,
    instead of a full-width scatter-add at every compaction.

    Cost: one (W_in,) sort + three row gathers.  Every downstream
    per-iteration cost (shading gathers, coherence sort, traversal, BRDF
    math) scales with the static width, and occupancy collapses after
    bounce 0 on the bunny bench scene (bench.py prints it per bounce).
    """
    w_in = state.lidx.shape[0]
    active = state.active
    n_active = jnp.sum(active.astype(jnp.int32))
    u = stream_uniforms(key, stream_base + it, (1, w_in),
                        lane_offset=state.gid, key_rows=key_rows,
                        lanes_per_key=lanes_per_key)[0]
    skey = jnp.where(active, sg(u), 2.0)   # inactive lanes sort last
    order = jnp.arange(w_in, dtype=jnp.int32)
    _, perm = jax.lax.sort((skey, order), num_keys=1, is_stable=False)
    sel = perm[:w_out]

    # row gathers move the whole state
    frows = jnp.stack([
        state.origin.x, state.origin.y, state.origin.z,
        state.direction.x, state.direction.y, state.direction.z,
        state.t, state.bu, state.bv,
        state.throughput.x, state.throughput.y, state.throughput.z,
        state.prev_pdf,
        state.color.x, state.color.y, state.color.z], axis=-1)[sel]
    irows = jnp.stack([state.slot, state.bounces_used,
                       state.active.astype(jnp.int32),
                       state.lidx, state.gid], axis=-1)[sel]
    # dropped lanes: retired radiance rows, deposited by the caller
    sel_drop = perm[w_out:]
    drop_lidx = state.lidx[sel_drop]
    drop_color = jnp.stack([state.color.x, state.color.y,
                            state.color.z], axis=-1)[sel_drop]
    new_active = irows[:, 2] > 0
    scale = jnp.where(n_active > w_out,
                      n_active.astype(jnp.float32) / jnp.float32(w_out), 1.0)
    rr_dropped = jnp.maximum(n_active - w_out, 0).astype(jnp.float32)
    thr = V3(frows[:, 9], frows[:, 10], frows[:, 11]) * scale
    return PathState(
        origin=V3(frows[:, 0], frows[:, 1], frows[:, 2]),
        direction=V3(frows[:, 3], frows[:, 4], frows[:, 5]),
        t=frows[:, 6], slot=irows[:, 0], bu=frows[:, 7], bv=frows[:, 8],
        throughput=thr,
        color=V3(frows[:, 13], frows[:, 14], frows[:, 15]),
        bounces_used=irows[:, 1], active=new_active,
        prev_pdf=frows[:, 12], lidx=irows[:, 3], gid=irows[:, 4]
    ), (drop_lidx, drop_color), rr_dropped


def _sort_state(scene, state: PathState) -> PathState:
    """Reorder the whole path state into Morton order of the current hit
    points (inactive lanes last).

    This replaces the per-launch sort+unsort of sorted_intersect
    (cfg.sort_state): permuting the STATE once per iteration keeps every
    subsequent traversal launch coherent with hits returned already
    aligned, eliminating the inverse row scatter, and halves the sorted
    lane count (shadow segments inherit the state's order; their
    env-bin-clustered directions stay coherent under a position-major
    key).  Estimator-neutral: all
    per-lane randomness is keyed by gid and radiance deposits by lidx, so
    lane order never enters the estimator (same argument as compaction's
    survivor reshuffle)."""
    w = state.lidx.shape[0]
    hit_p = state.origin + state.direction * state.t
    wmin = scene.node_min[0]
    extent = jnp.maximum(scene.node_max[0] - wmin, 1e-6)
    morton = _morton21((hit_p.x - wmin[0]) / extent[0],
                       (hit_p.y - wmin[1]) / extent[1],
                       (hit_p.z - wmin[2]) / extent[2])
    key = jnp.where(state.active, morton, jnp.int32(1) << 30)
    order = jnp.arange(w, dtype=jnp.int32)
    _, perm = jax.lax.sort((sg(key), order), num_keys=2, is_stable=False)
    frows = jnp.stack([
        state.origin.x, state.origin.y, state.origin.z,
        state.direction.x, state.direction.y, state.direction.z,
        state.t, state.bu, state.bv,
        state.throughput.x, state.throughput.y, state.throughput.z,
        state.color.x, state.color.y, state.color.z,
        state.prev_pdf], axis=-1)[perm]
    irows = jnp.stack([state.slot, state.bounces_used,
                       state.active.astype(jnp.int32),
                       state.lidx, state.gid], axis=-1)[perm]
    return PathState(
        origin=V3(frows[:, 0], frows[:, 1], frows[:, 2]),
        direction=V3(frows[:, 3], frows[:, 4], frows[:, 5]),
        t=frows[:, 6], bu=frows[:, 7], bv=frows[:, 8],
        throughput=V3(frows[:, 9], frows[:, 10], frows[:, 11]),
        color=V3(frows[:, 12], frows[:, 13], frows[:, 14]),
        prev_pdf=frows[:, 15],
        slot=irows[:, 0], bounces_used=irows[:, 1],
        active=irows[:, 2] > 0, lidx=irows[:, 3], gid=irows[:, 4])


def _compact_groups(cfg: RenderConfig, n: int):
    """Run-length-encode the compaction schedule into (width, n_iters)
    groups; iterations within a group share one lax.scan (one compiled
    body per distinct width).  Divisors may be fractional (e.g. 1.3 for
    the first bounce, whose width only needs to cover the primary hit
    rate), and widths are rounded up to a multiple of 1024 (a 32x32
    screen tile, runtime/layout.py) so launch widths stay few and
    block-aligned; what the rounding is worth on the GPU is not measured
    yet."""
    import math
    sched = cfg.compact_schedule
    groups = []
    prev_w = n
    for it in range(cfg.max_iters):
        div = sched[min(it, len(sched) - 1)]
        w = min(prev_w, math.ceil(n / div / 1024) * 1024, n)
        if groups and w == groups[-1][0]:
            groups[-1][1] += 1
        else:
            groups.append([w, 1])
        prev_w = w
    return groups


def trace_paths(scene, cfg: RenderConfig, meta, origin: V3, direction: V3,
                key, lane_offset=0, return_stats: bool = False):
    """Path-trace one sample for every input ray. Returns V3 (N,) radiance
    (or (radiance, TraceStats) when return_stats).

    lane_offset: global lane index of ray 0 (scalar, or an (N,) array of
    explicit ids) — threads through to the counter-based RNG so sharded
    renders reproduce the single-device estimator bit-for-bit
    (core/rng.py)."""
    n = origin.x.shape[0]
    if cfg.max_iters >= _RR_STREAM:
        # shading iterations use RNG streams 1..max_iters; compaction
        # survivor selection uses _RR_STREAM + it.  Overlap would correlate
        # RR selection with shading randomness and silently bias the
        # estimator.
        raise ValueError(
            f"max_iters={cfg.max_iters} collides with the compaction RNG "
            f"stream base {_RR_STREAM}; lower bounces/extra_refraction_iters")
    env_hw = (meta.env_h, meta.env_w)
    lane_offset = jnp.asarray(lane_offset)
    if lane_offset.ndim == 0:
        gid0 = lane_offset.astype(jnp.int32) + jnp.arange(n, dtype=jnp.int32)
    else:
        gid0 = lane_offset.astype(jnp.int32)

    # Loop-invariant texture tables, built ONCE outside the bounce scan
    # (don't rely on XLA hoisting materialized
    # buffers out of the scan body on every backend):
    tex = _packed_tables(scene, cfg, meta)
    attr = _attr_table(scene)

    primary = intersect(scene, cfg, meta, origin, direction)
    prim_slot = primary.slot
    miss = prim_slot < 0
    zero = vec.splat(0.0, like=origin.x)
    color = where(miss, env_radiance_rows(tex.env6, env_hw, direction,
                                          scene.env_theta), zero)

    state = PathState(
        origin=origin, direction=direction, t=primary.t, slot=prim_slot,
        bu=primary.u, bv=primary.v,
        throughput=vec.splat(1.0, like=origin.x), color=color,
        bounces_used=jnp.zeros(n, jnp.int32), active=~miss,
        prev_pdf=jnp.full(n, 1.0e16, jnp.float32),
        lidx=jnp.arange(n, dtype=jnp.int32), gid=gid0)

    def body(state: PathState, it):
        if cfg.sort_state:
            state = _sort_state(scene, state)
        w = state.lidx.shape[0]
        u = stream_uniforms(key, 1 + it, (11, w), lane_offset=state.gid)
        return _shade_and_scatter(scene, cfg, meta, state, u, env_hw,
                                  attr, tex)

    rr_lanes = jnp.float32(0.0)
    if not cfg.compact:
        state, per_it = jax.lax.scan(body, state, jnp.arange(cfg.max_iters))
        if cfg.sort_state:
            # state lanes are in Morton order; map colors back to rays
            out = jnp.zeros((n, 3), jnp.float32).at[state.lidx].set(
                jnp.stack([state.color.x, state.color.y, state.color.z],
                          -1), unique_indices=True,
                mode="promise_in_bounds")
            c = V3(out[:, 0], out[:, 1], out[:, 2])
        else:
            c = state.color
    else:
        drops = []
        per_groups = []
        it0 = 0
        for w, count in _compact_groups(cfg, n):
            if w < state.lidx.shape[0]:
                state, drop, dropped = _compact(state, key, it0, w)
                drops.append(drop)
                rr_lanes = rr_lanes + dropped
            state, per_g = jax.lax.scan(body, state,
                                        jnp.arange(it0, it0 + count))
            per_groups.append(per_g)
            it0 += count
        # deferred deposits: drops + final survivors partition the lanes,
        # so ONE scatter-set writes every framebuffer lane exactly once
        all_idx = jnp.concatenate(
            [d[0] for d in drops] + [state.lidx])
        all_col = jnp.concatenate(
            [d[1] for d in drops]
            + [jnp.stack([state.color.x, state.color.y, state.color.z],
                         -1)])
        acc = jnp.zeros((n, 3), jnp.float32).at[all_idx].set(
            all_col, unique_indices=True, mode="promise_in_bounds")
        c = V3(acc[:, 0], acc[:, 1], acc[:, 2])
        per_it = jax.tree.map(lambda *xs: jnp.concatenate(xs), *per_groups)

    radiance = V3(jnp.clip(c.x, 0.0, cfg.radiance_clamp),
                  jnp.clip(c.y, 0.0, cfg.radiance_clamp),
                  jnp.clip(c.z, 0.0, cfg.radiance_clamp))
    if not return_stats:
        return radiance
    n_active, n_shadow, visits = per_it
    stats = TraceStats(rays=jnp.float32(n) + jnp.sum(n_active)
                       + jnp.sum(n_shadow),
                       active=n_active, shadow=n_shadow, visits=visits,
                       rr_lanes=rr_lanes)
    return radiance, stats


def trace_paths_batched(scene, cfg: RenderConfig, meta, origin: V3,
                        direction: V3, batch_key, n_per: int,
                        return_stats: bool = False):
    """Cross-sample wavefront batch: K = n_total / n_per samples traced so
    their compacted tails share launches: a tail iteration of one sample
    holds a few tens of live lanes under the 1024-lane width floor, and K
    samples' tails pool into one launch.

    Two phases.  Early iterations — whose per-sample launch width exceeds
    cfg.wavefront_merge_width — run per sample under a lax.scan over the
    batch, exactly like K sequential trace_paths calls (merging them would
    only superlinearize the K*n-lane coherence sorts).  The K
    compacted states then concatenate into ONE path state for the
    remaining iterations, whose widths come from the schedule applied to
    the combined K*n lane count — so a divisor of 2048 at the tail yields
    a single 1024-lane launch carrying all K samples' survivors.

    Input rays are the K samples' rays concatenated (sample k's camera
    rays, generated with key fold_in(batch_key, k), at lanes
    [k*n_per, (k+1)*n_per)).  Per-lane randomness in the merged phase is
    keyed by (fold_in(batch_key, lane//n_per), stream, lane%n_per)
    (core/rng.stream_uniforms key_rows), which reproduces each sample's
    unbatched streams bit-for-bit; compaction survivor selection pools
    lanes across samples, so results are bit-identical to K sequential
    trace_paths calls whenever RR does not fire (the same exactness
    contract as compaction itself, tests/test_compact.py) and unbiased
    when it does.

    Returns the SUM over the K samples of their (clamped, per-sample)
    radiance as V3 (n_per,) planes — the caller adds it to the
    accumulator and advances the sample count by K."""
    n_tot = origin.x.shape[0]
    k_samples = n_tot // n_per
    assert k_samples * n_per == n_tot, (n_tot, n_per)
    if cfg.max_iters >= _RR_STREAM:
        raise ValueError(
            f"max_iters={cfg.max_iters} collides with the compaction RNG "
            f"stream base {_RR_STREAM}; lower bounces/extra_refraction_iters")
    env_hw = (meta.env_h, meta.env_w)
    key_rows = rng.key_rows_for(batch_key, k_samples)
    tex = _packed_tables(scene, cfg, meta)
    attr = _attr_table(scene)

    # split the schedule: per-sample groups (phase A) vs merged groups
    groups = _compact_groups(cfg, n_per)
    merged = _compact_groups(cfg, n_tot)
    split = len(groups)
    for gi, (w, _) in enumerate(groups):
        if w <= cfg.wavefront_merge_width:
            split = gi
            break
    groups_a = groups[:split]
    its_a = sum(c for _, c in groups_a)
    # merged-phase groups realigned to the combined lane count
    groups_b = []
    itx = 0
    for w, count in merged:
        take = max(0, min(count, itx + count - its_a))
        if take and itx + count > its_a:
            groups_b.append([w, take])
        itx += count

    def body_scalar_key(key):
        def body(state: PathState, it):
            if cfg.sort_state:
                state = _sort_state(scene, state)
            w = state.lidx.shape[0]
            u = stream_uniforms(key, 1 + it, (11, w),
                                lane_offset=state.gid)
            return _shade_and_scatter(scene, cfg, meta, state, u, env_hw,
                                      attr, tex)
        return body

    ox = origin.x.reshape(k_samples, n_per)
    oy = origin.y.reshape(k_samples, n_per)
    oz = origin.z.reshape(k_samples, n_per)
    dx = direction.x.reshape(k_samples, n_per)
    dy = direction.y.reshape(k_samples, n_per)
    dz = direction.z.reshape(k_samples, n_per)

    def phase_a(_, k):
        o = V3(ox[k], oy[k], oz[k])
        d = V3(dx[k], dy[k], dz[k])
        skey = jax.random.fold_in(batch_key, k)
        primary = intersect(scene, cfg, meta, o, d)
        miss = primary.slot < 0
        zero = vec.splat(0.0, like=o.x)
        color = where(miss, env_radiance_rows(tex.env6, env_hw, d,
                                              scene.env_theta), zero)
        state = PathState(
            origin=o, direction=d, t=primary.t, slot=primary.slot,
            bu=primary.u, bv=primary.v,
            throughput=vec.splat(1.0, like=o.x), color=color,
            bounces_used=jnp.zeros(n_per, jnp.int32), active=~miss,
            prev_pdf=jnp.full(n_per, 1.0e16, jnp.float32),
            lidx=k * n_per + jnp.arange(n_per, dtype=jnp.int32),
            gid=jnp.arange(n_per, dtype=jnp.int32))
        rr = jnp.float32(0.0)
        per_a = []
        drops_a = []
        it0 = 0
        body = body_scalar_key(skey)
        for w, count in groups_a:
            if w < state.lidx.shape[0]:
                state, drop, dropped = _compact(state, skey, it0, w)
                drops_a.append(drop)
                rr = rr + dropped
            state, per_g = jax.lax.scan(body, state,
                                        jnp.arange(it0, it0 + count))
            per_a.append(per_g)
            it0 += count
        per_it = (jax.tree.map(lambda *xs: jnp.concatenate(xs), *per_a)
                  if per_a else None)
        # shrink to the merged phase's per-sample share BEFORE stacking —
        # per-sample selection with the sample's own key, exactly what the
        # unbatched estimator does at this boundary, and it keeps the
        # merge concatenation at K * (w_b/K) lanes instead of K * w_m.
        # Stream base _RR_STREAM + max_iters: when K * w_b exceeds the
        # first merged width (batch_spp not a power of two) the merged
        # phase compacts AGAIN at stream _RR_STREAM + it0 with the same
        # per-sample keys and local lane ids — drawing this shrink's
        # uniforms from the same stream would make the two selections
        # identical and correlate RR survivor choice with lane liveness
        # (a small estimator bias).  The offset
        # base keeps the draws independent; shading streams (1..max_iters)
        # and compaction streams (_RR_STREAM..+max_iters) stay clear of
        # _RR_STREAM + max_iters..+2*max_iters by the max_iters < _RR_STREAM
        # guard above.
        if groups_b:
            w_b = -(-groups_b[0][0] // k_samples)
            if w_b < state.lidx.shape[0]:
                state, drop, dropped = _compact(
                    state, skey, it0, w_b,
                    stream_base=_RR_STREAM + cfg.max_iters)
                drops_a.append(drop)
                rr = rr + dropped
        # globalize gid for the merged phase's key_rows lookup
        state = state._replace(gid=k * n_per + state.gid)
        return None, (state, per_it, rr, tuple(drops_a))

    _, (states, per_a, rr_a, drops_a) = jax.lax.scan(
        phase_a, None, jnp.arange(k_samples))
    rr_lanes = jnp.sum(rr_a)
    per_groups = ([jax.tree.map(lambda x: jnp.sum(x, axis=0), per_a)]
                  if per_a is not None else [])
    # stacked (K, m)/(K, m, 3) drop rows -> flat
    drops = [(i.reshape(-1), c.reshape(-1, 3)) for i, c in drops_a]

    # ---- merge: (K, w_m) stacked planes -> one (K*w_m,) state ----------
    state = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), states)

    def body(state: PathState, it):
        if cfg.sort_state:
            state = _sort_state(scene, state)
        w = state.lidx.shape[0]
        u = stream_uniforms(batch_key, 1 + it, (11, w),
                            lane_offset=state.gid, key_rows=key_rows,
                            lanes_per_key=n_per)
        return _shade_and_scatter(scene, cfg, meta, state, u, env_hw,
                                  attr, tex)

    it0 = its_a
    for w, count in groups_b:
        if w < state.lidx.shape[0]:
            state, drop, dropped = _compact(state, batch_key, it0, w,
                                            key_rows=key_rows,
                                            lanes_per_key=n_per)
            drops.append(drop)
            rr_lanes = rr_lanes + dropped
        state, per_g = jax.lax.scan(body, state,
                                    jnp.arange(it0, it0 + count))
        per_groups.append(per_g)
        it0 += count
    all_idx = jnp.concatenate([d[0] for d in drops] + [state.lidx])
    all_col = jnp.concatenate(
        [d[1] for d in drops]
        + [jnp.stack([state.color.x, state.color.y, state.color.z], -1)])
    acc = jnp.zeros((n_tot, 3), jnp.float32).at[all_idx].set(
        all_col, unique_indices=True, mode="promise_in_bounds")
    per_it = jax.tree.map(lambda *xs: jnp.concatenate(xs), *per_groups)

    # per-sample radiance clamp, then sum over the batch
    c = jnp.clip(acc.reshape(k_samples, n_per, 3), 0.0, cfg.radiance_clamp)
    total = jnp.sum(c, axis=0)
    radiance = V3(total[:, 0], total[:, 1], total[:, 2])
    if not return_stats:
        return radiance
    n_active, n_shadow, visits = per_it
    stats = TraceStats(rays=jnp.float32(n_tot) + jnp.sum(n_active)
                       + jnp.sum(n_shadow),
                       active=n_active, shadow=n_shadow, visits=visits,
                       rr_lanes=rr_lanes)
    return radiance, stats


def _corner_lerp(c0: V3, c1: V3, c2: V3, w0, u, v) -> V3:
    return c0 * w0 + c1 * u + c2 * v


def _attr_table(scene):
    """The (S, 43) per-slot shading-attribute row table.

    The 42 per-slot attribute planes are stacked into one row table
    fetched with a single gather per bounce.
    Built once per trace (outside the bounce scan) and differentiable: its
    VJP un-stacks back onto emit/ior/dielectric, the train-step
    parameters."""
    return jnp.stack([
        scene.nrm0.x, scene.nrm0.y, scene.nrm0.z,
        scene.nrm1.x, scene.nrm1.y, scene.nrm1.z,
        scene.nrm2.x, scene.nrm2.y, scene.nrm2.z,
        scene.tan0.x, scene.tan0.y, scene.tan0.z,
        scene.tan1.x, scene.tan1.y, scene.tan1.z,
        scene.tan2.x, scene.tan2.y, scene.tan2.z,
        scene.btn0.x, scene.btn0.y, scene.btn0.z,
        scene.btn1.x, scene.btn1.y, scene.btn1.z,
        scene.btn2.x, scene.btn2.y, scene.btn2.z,
        scene.uv0u, scene.uv0v, scene.uv1u, scene.uv1v,
        scene.uv2u, scene.uv2v,
        scene.emit.x, scene.emit.y, scene.emit.z,
        scene.ior, scene.dielectric,
        # atlas layer ids as f32 (exact below 2^24 layers)
        scene.map_d.astype(jnp.float32), scene.map_e.astype(jnp.float32),
        scene.map_n.astype(jnp.float32), scene.map_mr.astype(jnp.float32),
        scene.map_c.astype(jnp.float32),
    ], axis=-1)


def _shade_and_scatter(scene, cfg: RenderConfig, meta, s: PathState, u,
                       env_hw, attr, tex: TexTables):
    """One shading+scatter iteration."""
    def trace_fn(o, d, a, tmax, any_hit=False):
        return sorted_intersect(scene, cfg, meta, o, d, a, tmax=tmax,
                                any_hit=any_hit)

    active = s.active & (s.slot >= 0)
    slot = sg(jnp.maximum(s.slot, 0))

    def env_rad(d):
        if tex.env6 is not None:
            return env_radiance_rows(tex.env6, env_hw, d, scene.env_theta)
        return env_radiance(scene.env_rgb, env_hw, d, scene.env_theta)

    # ---- gather hit attributes: ONE (N, 43) row gather -----------------
    row = attr[slot]                                   # (N, 43)

    def col3(i):
        return V3(row[:, i], row[:, i + 1], row[:, i + 2])

    emitt = col3(33)
    ior = row[:, 36]
    dielectric = row[:, 37]
    bu, bv = sg(s.bu), sg(s.bv)
    w0 = 1.0 - bu - bv
    tex_u = row[:, 27] * w0 + row[:, 29] * bu + row[:, 31] * bv
    tex_v = row[:, 28] * w0 + row[:, 30] * bu + row[:, 32] * bv
    bary_n = _corner_lerp(col3(0), col3(3), col3(6), w0, bu, bv)
    bary_t = _corner_lerp(col3(9), col3(12), col3(15), w0, bu, bv)
    bary_bt = _corner_lerp(col3(18), col3(21), col3(24), w0, bu, bv)

    # ---- atlas fetches (tracer.fs:453-456) -----------------------------
    if tex.mat_tex is not None:
        map_c = sg(row[:, 42]).astype(jnp.int32)
        tex_diffuse, tex_emissive, tn, mr = atlas_fetch_all(
            tex.mat_tex, meta, map_c, tex_u, tex_v)
    else:
        map_d = sg(row[:, 38]).astype(jnp.int32)
        map_e = sg(row[:, 39]).astype(jnp.int32)
        map_n = sg(row[:, 40]).astype(jnp.int32)
        map_mr = sg(row[:, 41]).astype(jnp.int32)
        ar = tex.atlas_rows
        tex_diffuse = atlas_fetch_rgb(scene, meta, map_d, tex_u, tex_v, ar)
        tex_emissive = atlas_fetch_rgb(scene, meta, map_e, tex_u, tex_v, ar)
        mr = atlas_fetch_rgb(scene, meta, map_mr, tex_u, tex_v, ar)
        tn = atlas_fetch_rgb(scene, meta, map_n, tex_u, tex_v, ar)
    metallic, roughness = mr.x, mr.y ** 2                # tracer.fs:457
    tex_normal = V3((tn.x - 0.5) * 2.0, (tn.y - 0.5) * 2.0, tn.z)

    # ---- shading frame (tracer.fs:332-337,459-463) --------------------
    macro_n = normalize(bary_t * tex_normal.x + bary_bt * tex_normal.y
                        + bary_n * tex_normal.z)
    inside = dot(-s.direction, bary_n) < 0.0
    n1 = jnp.where(inside, ior, 1.0)
    n2 = jnp.where(inside, 1.0, ior)
    macro_n = where(inside, -macro_n, macro_n)
    hit_p = s.origin + s.direction * s.t
    offset_out = hit_p + macro_n * (cfg.epsilon * 2.0)

    # ---- emissive (tracer.fs:467) -------------------------------------
    zero = vec.splat(0.0, like=active.astype(jnp.float32))
    if cfg.use_light_nee:
        # weight the light-sampled (constant-emittance) term against the
        # bsdf pdf that produced this hit: standard emitter-hit MIS
        cos_l = jnp.abs(dot(bary_n, -s.direction))
        p_light_hit = (s.t * s.t) / jnp.maximum(
            cos_l * scene.light_area, 1e-12)
        w_hit, _ = brdf.mis_weights(s.prev_pdf, p_light_hit)
        emit_add = (s.throughput * tex_emissive * tex_diffuse
                    * cfg.emissive_scale + s.throughput * emitt * w_hit)
    else:
        emit_add = (s.throughput * tex_emissive * tex_diffuse
                    * cfg.emissive_scale + s.throughput * emitt)
    color = s.color + where(active, emit_add, zero)

    incident = -s.direction

    # ---- samples -------------------------------------------------------
    micro_n = brdf.sample_microfacet(macro_n, roughness, sg(u[0]), sg(u[1]))
    if cfg.nee_env_nearest and tex.env6 is not None:
        # fused draw: direction + pdf + radiance-at-the-sampled-texel in
        # ONE env gather (vs two bilinear gathers at the reconstructed
        # direction)
        env_dir, env_pdf, nee_rad = sample_env_bins_radiance(
            tex.bins4, tex.env6, scene.n_bins, env_hw, scene.env_theta,
            sg(u[2]), sg(u[3]), sg(u[4]))
    else:
        env_dir, env_pdf = sample_env_bins(
            tex.bins4, scene.n_bins, env_hw, scene.env_theta,
            sg(u[2]), sg(u[3]), sg(u[4]))
        nee_rad = None
    env_dir = sg(env_dir)
    cos_env = dot(macro_n, env_dir)

    fresnel = brdf.schlick(incident, micro_n, n1, n2)
    p_specular = fresnel * (1.0 - metallic) + metallic   # mix(f, 1, metallic)
    specular = sg(p_specular) > u[5]
    refractive = ~specular & (dielectric >= 0.0)
    diffuse_lobe = ~specular & ~refractive

    # specular branch
    spec_dir = brdf.reflect(-incident, micro_n)
    spec_pdf = brdf.gtr2_pdf(incident, macro_n, roughness, spec_dir)
    spec_bsdf = (brdf.eval_specular(incident, macro_n, tex_diffuse, metallic,
                                    roughness, spec_dir)
                 * (jnp.clip(dot(macro_n, spec_dir), 0.0, 1.0)
                    / jnp.maximum(sg(spec_pdf), 1e-12)))
    spec_env = (brdf.eval_specular(incident, macro_n, tex_diffuse, metallic,
                                   roughness, env_dir)
                * (jnp.clip(cos_env, 0.0, 1.0) / env_pdf))

    # refraction branch
    refr_dir = brdf.refract(s.direction, micro_n, n1 / n2)
    # diffuse branch
    diff_dir = brdf.sample_lambert(macro_n, sg(u[6]), sg(u[7]))
    diff_pdf = brdf.lambert_pdf(macro_n, diff_dir)
    diff_bsdf = (brdf.eval_lambert(tex_diffuse)
                 * (jnp.clip(dot(macro_n, diff_dir), 0.0, 1.0)
                    / jnp.maximum(sg(diff_pdf), 1e-12)))
    diff_env = (brdf.eval_lambert(tex_diffuse)
                * (jnp.clip(cos_env, 0.0, 1.0) / env_pdf))

    new_dir = where(specular, spec_dir, where(refractive, refr_dir, diff_dir))
    new_dir = sg(normalize(new_dir))
    bsdf_pdf = jnp.where(specular, spec_pdf,
                         jnp.where(refractive, 1.0, diff_pdf))
    one = vec.splat(1.0, like=u[0])
    bsdf_throughput = where(specular, spec_bsdf,
                            where(refractive, one, diff_bsdf))
    env_throughput = where(specular, spec_env,
                           where(refractive, zero, diff_env))
    offset_in = hit_p - macro_n * (cfg.epsilon * 2.0)
    new_origin = where(refractive, offset_in, offset_out)

    # Beer's-law-ish absorption when exiting a medium (tracer.fs:497) —
    # replaces the lobe throughput whenever the hit was on the inside.
    beer = V3(*(jnp.maximum(1.0 - (1.0 - c) * s.t * dielectric, 0.0)
                for c in (tex_diffuse.x, tex_diffuse.y, tex_diffuse.z)))
    bsdf_throughput = where(inside, beer, bsdf_throughput)

    w_env, w_bsdf = brdf.mis_weights(env_pdf, sg(bsdf_pdf))

    # ---- traversal: one nearest-hit launch for scatter rays, one
    # any-hit launch for the occlusion set (env shadow + light shadow).
    # Occlusion rays only need a boolean, so each ray's walk retires at
    # its first hit (ops/bvh.py any_hit).  cfg.split_shadow selects this;
    # the default is a single batched nearest-hit launch.
    park = vec.splat(1.0e9, like=u[0])
    up = V3(jnp.zeros_like(u[0]), jnp.ones_like(u[0]), jnp.zeros_like(u[0]))
    scat_o = where(active, new_origin, park)
    scat_d = where(active, new_dir, up)
    scat_tmax = jnp.full_like(u[0], cfg.max_t)

    shadow_wanted = active & (dielectric < 0.0) & (cos_env > 0.0)
    shad_o = where(shadow_wanted, offset_out, park)
    shad_d = where(shadow_wanted, env_dir, up)
    shadow_tmax = jnp.where(shadow_wanted, cfg.max_t, 0.0)

    seg_o = [scat_o, shad_o]
    seg_d = [scat_d, shad_d]
    seg_t = [scat_tmax, shadow_tmax]
    seg_a = [active, shadow_wanted]

    if cfg.use_light_nee:
        li = jnp.clip(jnp.searchsorted(scene.light_cdf, sg(u[8])),
                      0, scene.light_cdf.shape[0] - 1)
        lv0 = vec.gather(scene.light_v0, li)
        le1 = vec.gather(scene.light_e1, li)
        le2 = vec.gather(scene.light_e2, li)
        su = jnp.sqrt(sg(u[9]))
        p_l = lv0 + le1 * (1.0 - su) + le2 * (sg(u[10]) * su)
        to_l = p_l - offset_out
        dist2 = dot(to_l, to_l)
        dist = jnp.sqrt(dist2)
        wi = to_l * jnp.reciprocal(jnp.maximum(dist, 1e-12))
        ln = normalize(vec.cross(le1, le2))
        cos_li = jnp.abs(dot(ln, -wi))
        pdf_l = dist2 / jnp.maximum(cos_li * scene.light_area, 1e-12)
        cos_s = dot(macro_n, wi)
        light_wanted = (active & (dielectric < 0.0) & (cos_s > 0.0)
                        & (scene.n_light_tris > 0))
        seg_o.append(where(light_wanted, offset_out, park))
        seg_d.append(where(light_wanted, wi, up))
        seg_t.append(jnp.where(light_wanted, dist * (1.0 - 1e-3), 0.0))
        seg_a.append(light_wanted)

    cat = jnp.concatenate
    n = active.shape[0]
    if cfg.split_shadow:
        nxt = trace_fn(seg_o[0], seg_d[0], seg_a[0], seg_t[0])
        occ = trace_fn(
            V3(cat([o.x for o in seg_o[1:]]), cat([o.y for o in seg_o[1:]]),
               cat([o.z for o in seg_o[1:]])),
            V3(cat([d.x for d in seg_d[1:]]), cat([d.y for d in seg_d[1:]]),
               cat([d.z for d in seg_d[1:]])),
            cat(seg_a[1:]), cat(seg_t[1:]), any_hit=True)

        def seg(i):
            if i == 0:
                return nxt
            return jax.tree.map(lambda a: a[(i - 1) * n:i * n], occ)

        hits_visits = nxt.visits
    else:
        hits = trace_fn(
            V3(cat([o.x for o in seg_o]), cat([o.y for o in seg_o]),
               cat([o.z for o in seg_o])),
            V3(cat([d.x for d in seg_d]), cat([d.y for d in seg_d]),
               cat([d.z for d in seg_d])),
            cat(seg_a), cat(seg_t))

        def seg(i):
            return jax.tree.map(lambda a: a[i * n:(i + 1) * n], hits)

        nxt = seg(0)
        hits_visits = hits.visits[:n]
    shadow_open = seg(1).slot < 0

    # ---- NEE env contribution (tracer.fs:499-505) ----------------------
    nee_L = nee_rad if nee_rad is not None else env_rad(env_dir)
    nee = (s.throughput * env_throughput * nee_L * w_env)
    color = color + where(shadow_wanted & shadow_open, nee, zero)

    # ---- NEE area-light contribution (working version of the
    # reference's dead lightTex path; MIS vs the sampled lobe) -----------
    if cfg.use_light_nee:
        spec_li = (brdf.eval_specular(incident, macro_n, tex_diffuse,
                                      metallic, roughness, wi)
                   * (jnp.clip(cos_s, 0.0, 1.0) / pdf_l))
        diff_li = (brdf.eval_lambert(tex_diffuse)
                   * (jnp.clip(cos_s, 0.0, 1.0) / pdf_l))
        light_tp = where(specular, spec_li,
                         where(refractive, zero, diff_li))
        Le = vec.gather(scene.emit, scene.light_slot[li])
        l_open = seg(2).slot < 0
        w_l, _ = brdf.mis_weights(pdf_l, sg(bsdf_pdf))
        l_nee = s.throughput * light_tp * Le * w_l
        color = color + where(light_wanted & l_open, l_nee, zero)

    throughput = where(active, s.throughput * bsdf_throughput, s.throughput)

    # ---- scatter-ray env hit (tracer.fs:509-512) -----------------------
    scat_miss = active & (nxt.slot < 0)
    if cfg.escape_env_nearest and tex.env6 is not None:
        esc_L = env_radiance_rows_nearest(tex.env6, env_hw, new_dir,
                                          scene.env_theta)
    else:
        esc_L = env_rad(new_dir)
    esc = throughput * esc_L * w_bsdf
    color = color + where(scat_miss, esc, zero)

    # ---- bookkeeping ----------------------------------------------------
    bounces_used = s.bounces_used + (active & ~refractive).astype(jnp.int32)
    still_active = active & ~scat_miss & (bounces_used < cfg.bounces)

    n_shadow = jnp.sum(shadow_wanted.astype(jnp.float32))
    if cfg.use_light_nee:
        n_shadow = n_shadow + jnp.sum(light_wanted.astype(jnp.float32))
    per_it = (jnp.sum(active.astype(jnp.float32)), n_shadow,
              jnp.sum(hits_visits.astype(jnp.float32)))

    return PathState(
        origin=where(active, new_origin, s.origin),
        direction=where(active, new_dir, s.direction),
        t=jnp.where(active, nxt.t, s.t),
        slot=jnp.where(active, nxt.slot, s.slot),
        bu=jnp.where(active, nxt.u, s.bu),
        bv=jnp.where(active, nxt.v, s.bv),
        throughput=throughput,
        color=color,
        bounces_used=bounces_used,
        active=still_active,
        prev_pdf=jnp.where(active & ~refractive, sg(bsdf_pdf), s.prev_pdf),
        lidx=s.lidx, gid=s.gid,
    ), per_it


def trace_heatmap(scene, cfg: RenderConfig, meta, origin: V3,
                  direction: V3) -> V3:
    """BVH traversal-cost heatmap (reference mode=test, bvh_test.fs:224-232):
    node-visit count scaled by heatmap_scale as grayscale.

    Each pixel reports the wide nodes its own ray fetched, root included,
    the reference's per-pixel semantics (the "brute" oracle reports 0)."""
    hit = intersect(scene, cfg, meta, origin, direction)
    v = hit.visits.astype(jnp.float32) * cfg.heatmap_scale
    return V3(v, v, v)
