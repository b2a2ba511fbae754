"""Wide-BVH traversal: one ray per lane, each ray with its own stack.

This is the reference's per-thread stack walk (reference
shader/tracer.fs:366-404 intersectScene) over the packed wide tables of
ops/packing.py.  One visit step, shared by both implementations below:

  * an entry whose box distance is no longer closer than the best hit is
    dropped without a fetch (nodes are pushed with their entry distance);
  * a node visit fetches the node's row, slab-tests its `width` children,
    pushes the wanted ones far-to-near (children are pre-sorted along the
    node's principal axis; the ray's direction sign on that axis picks the
    order) and continues straight into the nearest one;
  * a leaf visit Moller-Trumbores the leaf's `leaf_size` triangles;
  * otherwise the ray pops its stack.

Two implementations of that one step:

  * `walk_kernel`: a Pallas kernel compiled through Triton for the GPU.
    One program walks BLOCK rays, one ray per lane; rows are fetched with
    per-lane gathers and each ray's stack lives in a scratch buffer in
    device memory (cached by L1/L2).  Runs in interpret mode on the CPU,
    which is how the tests check it.
  * `walk_plain`: the same step in jnp/lax over all rays at once, a
    `lax.while_loop` that runs until the slowest ray is done.  It is the
    kernel's reference, the CPU implementation, and what XLA compiles when
    timed against the kernel.

`traverse` picks the kernel when the call is compiled for CUDA and the
plain walk when it is compiled for the CPU (`lax.platform_dependent`);
no other platform is supported.

The stack holds `stack_depth` entries.  A node visit at tree depth l
leaves at most 1 + (l + 1) * (width - 1) entries, so the scene's
`pk_stack_depth` = width * (depth + 2) (scene/schema.py) cannot overflow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fspt_tpu.core.vec import V3

MAX_T = 1.0e5          # reference tracer.fs:10
SENTINEL = np.int32(np.iinfo(np.int32).min)   # stack-bottom / done marker
BLOCK = 32             # rays per kernel program (one warp)
_TRI_EPS = 1.0e-6      # reference tracer.fs:11 EPSILON


class PacketHit(NamedTuple):
    t: jnp.ndarray        # (N,) f32 — tmax (default MAX_T) on miss
    slot: jnp.ndarray     # (N,) i32 — padded triangle slot, -1 on miss
    u: jnp.ndarray        # (N,) f32 — barycentric weight of corner 1
    v: jnp.ndarray        # (N,) f32 — barycentric weight of corner 2
    visits: jnp.ndarray   # (N,) i32 — wide nodes fetched, root included


def _safe_inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                           jnp.where(d < 0, -1e-20, 1e-20), d)


class _Ray(NamedTuple):
    o: tuple    # 3 x (B,)
    d: tuple
    inv: tuple


class _Fetched(NamedTuple):
    box: tuple      # 6 x (B, width): min.xyz, max.xyz of each child
    link: jnp.ndarray   # (B, width) f32 child links (ops/packing.py)
    axis: jnp.ndarray   # (B,) f32 sort axis of the node
    tri: tuple      # 9 x (B, leaf_size): v0.xyz, e1.xyz, e2.xyz


class _Walk(NamedTuple):
    cur: jnp.ndarray     # (B,) i32 entry: node >= 0, leaf -(ord+1), SENTINEL
    cur_t: jnp.ndarray   # (B,) f32 entry distance of cur
    ptr: jnp.ndarray     # (B,) i32 stack entries held (slot 0 = SENTINEL)
    t: jnp.ndarray
    slot: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    visits: jnp.ndarray


def _init_walk(tmax) -> _Walk:
    b = tmax.shape[0]
    return _Walk(cur=jnp.where(tmax > 0.0, 0, SENTINEL).astype(jnp.int32),
                 cur_t=jnp.full((b,), -jnp.inf, jnp.float32),
                 ptr=jnp.ones((b,), jnp.int32), t=tmax,
                 slot=jnp.full((b,), -1, jnp.int32),
                 u=jnp.zeros((b,), jnp.float32),
                 v=jnp.zeros((b,), jnp.float32),
                 visits=jnp.zeros((b,), jnp.int32))


def _children(ray: _Ray, f: _Fetched, best_t, is_node):
    """Slab test of every child box: (wanted (B, w) bool, entry t)."""
    col = lambda a: a[:, None]
    t1 = [(f.box[k] - col(ray.o[k])) * col(ray.inv[k]) for k in range(3)]
    t2 = [(f.box[3 + k] - col(ray.o[k])) * col(ray.inv[k]) for k in range(3)]
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(t1[0], t2[0]),
                                   jnp.minimum(t1[1], t2[1])),
                       jnp.minimum(t1[2], t2[2]))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(t1[0], t2[0]),
                                   jnp.maximum(t1[1], t2[1])),
                       jnp.maximum(t1[2], t2[2]))
    want = ((tmax >= tmin) & (tmax > 0.0) & (tmin < col(best_t))
            & (f.link > -1.0e8) & col(is_node))
    return want, tmin


def _leaf(ray: _Ray, f: _Fetched, best_t, leaf_size: int):
    """Nearest triangle of the fetched leaf closer than best_t:
    (hit, t, index in leaf, u, v); ties go to the lower index."""
    col = lambda a: a[:, None]
    dx, dy, dz = (col(a) for a in ray.d)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f.tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = jnp.abs(det) >= _TRI_EPS
    inv = 1.0 / jnp.where(ok_det, det, 1.0)
    tx = col(ray.o[0]) - v0x
    ty = col(ray.o[1]) - v0y
    tz = col(ray.o[2]) - v0z
    uu = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv
    tt = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = (ok_det & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
          & (uu + vv <= 1.0) & (tt > _TRI_EPS) & (tt < col(best_t)))
    tt = jnp.where(ok, tt, jnp.inf)
    t_best = jnp.min(tt, axis=1)
    idx = jax.lax.broadcasted_iota(jnp.int32, tt.shape, 1)
    k = jnp.min(jnp.where(tt == col(t_best), idx, leaf_size), axis=1)
    first = idx == col(k)
    u = jnp.sum(jnp.where(first, uu, 0.0), axis=1)
    v = jnp.sum(jnp.where(first, vv, 0.0), axis=1)
    return t_best < best_t, t_best, k, u, v


def _step(w: _Walk, ray: _Ray, fetch, stack_io, stack, *, width: int,
          leaf_size: int, any_hit: bool):
    """One visit of every lane (module docstring).  fetch(cur, is_node,
    is_leaf) -> _Fetched; stack_io(stack, pos, link, t, store_mask,
    pop_pos, pop_mask) -> (stack, popped link, popped t)."""
    alive = w.cur != SENTINEL
    fresh = alive & (w.cur_t < w.t)
    is_node = fresh & (w.cur >= 0)
    is_leaf = fresh & (w.cur < 0)
    f = fetch(w.cur, is_node, is_leaf)

    # ---- node: push wanted children far-to-near, continue into nearest
    want, tmin = _children(ray, f, w.t, is_node)
    ray_axis = jnp.where(f.axis == 0.0, ray.d[0],
                         jnp.where(f.axis == 1.0, ray.d[1], ray.d[2]))
    fwd = (ray_axis >= 0.0)[:, None]        # visit children 0..w-1
    want_i = want.astype(jnp.int32)
    incl = jnp.cumsum(want_i, axis=1)
    k = jnp.sum(want_i, axis=1)
    # number of wanted children this ray visits after child c
    later = jnp.where(fwd, k[:, None] - incl, incl - want_i)
    top = want & (later == (k - 1)[:, None])
    link = f.link.astype(jnp.int32)
    top_link = jnp.sum(jnp.where(top, link, 0), axis=1)
    top_t = jnp.sum(jnp.where(top, tmin, 0.0), axis=1)

    # ---- leaf: nearest triangle closer than the best hit so far
    hit, t_leaf, kk, u_leaf, v_leaf = _leaf(ray, f, w.t, leaf_size)
    hit = hit & is_leaf
    t = jnp.where(hit, t_leaf, w.t)
    slot = jnp.where(hit, (-w.cur - 1) * leaf_size + kk, w.slot)
    u = jnp.where(hit, u_leaf, w.u)
    v = jnp.where(hit, v_leaf, w.v)

    # ---- stack: the other wanted children go on, else pop
    pushed = k > 0
    pop = alive & ~pushed
    stack, p_link, p_t = stack_io(stack, w.ptr[:, None] + later, link, tmin,
                                  want & ~top, w.ptr - 1, pop)
    cur = jnp.where(pushed, top_link, jnp.where(pop, p_link, SENTINEL))
    cur_t = jnp.where(pushed, top_t, p_t)
    ptr = jnp.where(pushed, w.ptr + k - 1, jnp.where(pop, w.ptr - 1, w.ptr))
    if any_hit:
        cur = jnp.where(slot >= 0, SENTINEL, cur)
    visits = w.visits + is_node.astype(jnp.int32)
    return _Walk(cur=cur, cur_t=cur_t, ptr=ptr, t=t, slot=slot, u=u, v=v,
                 visits=visits), stack


def _rays(o: V3, d: V3) -> _Ray:
    return _Ray(o=(o.x, o.y, o.z), d=(d.x, d.y, d.z),
                inv=(_safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z)))


def _split_row(rows, width: int, leaf_size: int) -> _Fetched:
    """Field views of fetched (B, C) rows (ops/packing.py layout)."""
    box = tuple(rows[:, k * width:(k + 1) * width] for k in range(6))
    tri = rows[:, :9 * leaf_size].reshape(-1, leaf_size, 9)
    return _Fetched(box=box, link=rows[:, 6 * width:7 * width],
                    axis=rows[:, 7 * width],
                    tri=tuple(tri[..., j] for j in range(9)))


# ---------------------------------------------------------------------------
# plain walk (XLA)
# ---------------------------------------------------------------------------

def walk_plain(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
               leaf_size: int = 8, width: int = 8, any_hit: bool = False,
               stack_depth: int = 64) -> PacketHit:
    """The visit step of the module docstring in jnp/lax, all rays at once."""
    n = origin.x.shape[0]
    if tmax is None:
        tmax = jnp.full((n,), MAX_T, jnp.float32)
    n_nodes = nodes.shape[0]
    cols = max(7 * width + 1, 9 * leaf_size)
    table = jnp.concatenate([nodes, leaves], axis=0)[:, :cols]
    ray = _rays(origin, direction)
    lanes = jnp.arange(n, dtype=jnp.int32)[:, None]

    def fetch(cur, is_node, is_leaf):
        row = jnp.where(is_node, cur, jnp.where(is_leaf, n_nodes - cur - 1, 0))
        return _split_row(table[row], width, leaf_size)

    def stack_io(stack, pos, link, t, store_mask, pop_pos, pop_mask):
        s_link, s_t = stack
        pos = jnp.where(store_mask, pos, stack_depth)      # dropped
        s_link = s_link.at[lanes, pos].set(link, mode="drop")
        s_t = s_t.at[lanes, pos].set(t, mode="drop")
        at = jnp.maximum(pop_pos, 0)[:, None]
        p_link = jnp.take_along_axis(s_link, at, axis=1)[:, 0]
        p_t = jnp.take_along_axis(s_t, at, axis=1)[:, 0]
        return (s_link, s_t), p_link, p_t

    stack = (jnp.full((n, stack_depth), SENTINEL, jnp.int32),
             jnp.zeros((n, stack_depth), jnp.float32))
    step = functools.partial(_step, ray=ray, fetch=fetch, stack_io=stack_io,
                             width=width, leaf_size=leaf_size,
                             any_hit=any_hit)

    def body(carry):
        w, stack = carry
        return step(w, stack=stack)

    w, _ = jax.lax.while_loop(lambda c: jnp.any(c[0].cur != SENTINEL), body,
                              (_init_walk(tmax), stack))
    return PacketHit(t=w.t, slot=w.slot, u=w.u, v=w.v, visits=w.visits)


# ---------------------------------------------------------------------------
# Pallas kernel (Triton)
# ---------------------------------------------------------------------------

def _walk_kernel(table_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                 tmax_ref, t_ref, slot_ref, u_ref, v_ref, visits_ref,
                 stack_link_ref, stack_t_ref, *, n_nodes: int, width: int,
                 leaf_size: int, any_hit: bool, stack_depth: int, block: int,
                 barrier: bool):
    # each ray's stack is stack_depth entries plus one slot that masked
    # stores point at, so a masked store can never alias a live entry
    stride = stack_depth + 1
    lane = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
    base = lane * stride
    ray = _rays(V3(ox_ref[...], oy_ref[...], oz_ref[...]),
                V3(dx_ref[...], dy_ref[...], dz_ref[...]))
    plgpu.store(stack_link_ref.at[base], jnp.full((block,), SENTINEL,
                                                  jnp.int32))
    wcol = jax.lax.broadcasted_iota(jnp.int32, (block, width), 1)
    tcol = 9 * jax.lax.broadcasted_iota(jnp.int32, (block, leaf_size), 1)

    def fetch(cur, is_node, is_leaf):
        node_row = jnp.maximum(cur, 0) * 128
        node_at = node_row[:, None]
        leaf_at = ((n_nodes - cur - 1) * 128)[:, None]
        nmask = jnp.broadcast_to(is_node[:, None], (block, width))
        lmask = jnp.broadcast_to(is_leaf[:, None], (block, leaf_size))

        def nload(k):
            return plgpu.load(table_ref.at[node_at + k * width + wcol],
                              mask=nmask, other=0.0)

        def lload(j):
            return plgpu.load(table_ref.at[jnp.where(lmask, leaf_at, 0)
                                           + tcol + j],
                              mask=lmask, other=0.0)

        axis = plgpu.load(table_ref.at[node_row + 7 * width],
                          mask=is_node, other=0.0)
        return _Fetched(box=tuple(nload(k) for k in range(6)),
                        link=nload(6), axis=axis,
                        tri=tuple(lload(j) for j in range(9)))

    def stack_io(stack, pos, link, t, store_mask, pop_pos, pop_mask):
        at = base[:, None] + jnp.where(store_mask, pos, stack_depth)
        plgpu.store(stack_link_ref.at[at], link, mask=store_mask)
        plgpu.store(stack_t_ref.at[at], t, mask=store_mask)
        if barrier:
            # the 2-D stores and the 1-D pop below may place one ray on
            # different threads; make the stores visible block-wide
            plgpu.debug_barrier()
        at = base + jnp.maximum(pop_pos, 0)
        p_link = plgpu.load(stack_link_ref.at[at], mask=pop_mask,
                            other=SENTINEL)
        p_t = plgpu.load(stack_t_ref.at[at], mask=pop_mask, other=0.0)
        return stack, p_link, p_t

    step = functools.partial(_step, ray=ray, fetch=fetch, stack_io=stack_io,
                             stack=None, width=width, leaf_size=leaf_size,
                             any_hit=any_hit)

    def cond(w):
        return jnp.max((w.cur != SENTINEL).astype(jnp.int32)) > 0

    w = jax.lax.while_loop(cond, lambda w: step(w)[0],
                           _init_walk(tmax_ref[...]))
    t_ref[...] = w.t
    slot_ref[...] = w.slot
    u_ref[...] = w.u
    v_ref[...] = w.v
    visits_ref[...] = w.visits


def walk_kernel(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
                leaf_size: int = 8, width: int = 8, any_hit: bool = False,
                stack_depth: int = 64, block: int = BLOCK,
                interpret: bool = False) -> PacketHit:
    """The visit step of the module docstring as a Pallas/Triton kernel,
    one ray per lane.  Pads N up to a multiple of `block` with rays that
    start done (tmax 0)."""
    n = origin.x.shape[0]
    if tmax is None:
        tmax = jnp.full((n,), MAX_T, jnp.float32)
    n_pad = -(-n // block) * block

    def pad(a, value):
        return jnp.pad(a, (0, n_pad - n), constant_values=value)

    rays = [pad(a, 0.0) for a in (*origin, *direction)] + [pad(tmax, 0.0)]
    table = jnp.concatenate([nodes, leaves], axis=0).reshape(-1)
    kernel = functools.partial(
        _walk_kernel, n_nodes=int(nodes.shape[0]), width=width,
        leaf_size=leaf_size, any_hit=any_hit, stack_depth=stack_depth,
        block=block, barrier=not interpret)
    lane_block = pl.BlockSpec((block,), lambda i: (i,))
    whole = pl.BlockSpec()          # the whole array, indexed per lane
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    scratch = n_pad * (stack_depth + 1)
    t, slot, u, v, visits, _, _ = pl.pallas_call(
        kernel,
        grid=(n_pad // block,),
        in_specs=[whole] + [lane_block] * 7,
        out_specs=[lane_block] * 5 + [whole] * 2,
        out_shape=[f32, i32, f32, f32, i32,
                   jax.ShapeDtypeStruct((scratch,), jnp.int32),
                   jax.ShapeDtypeStruct((scratch,), jnp.float32)],
        compiler_params=plgpu.CompilerParams(num_warps=max(block // 32, 1),
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="bvh_walk",
    )(table, *rays)
    return PacketHit(t=t[:n], slot=slot[:n], u=u[:n], v=v[:n],
                     visits=visits[:n])


def traverse(nodes, leaves, origin: V3, direction: V3, tmax=None, *,
             leaf_size: int = 8, width: int = 8, any_hit: bool = False,
             stack_depth: int = 64, plain: bool = False) -> PacketHit:
    """Nearest-hit (or any-hit) traversal: the kernel where the call is
    compiled for CUDA, the plain walk where it is compiled for the CPU.
    plain=True takes the plain walk on every platform."""
    kw = dict(leaf_size=leaf_size, width=width, any_hit=any_hit,
              stack_depth=stack_depth)
    if tmax is None:
        tmax = jnp.full(origin.x.shape, MAX_T, jnp.float32)
    args = (nodes, leaves, origin, direction, tmax)
    if plain:
        return walk_plain(*args, **kw)
    return jax.lax.platform_dependent(
        *args, cpu=functools.partial(walk_plain, **kw),
        cuda=functools.partial(walk_kernel, **kw))
