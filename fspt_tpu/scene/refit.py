"""On-device BVH refit for transform-only animation (SURVEY §7.1).

The reference's animation mode re-ingests every animated prop per frame —
a full page reload, OBJ re-parse and GPU re-upload
(/root/reference/main.js:859-871).  Our animation driver inherited the
host-side analog: each frame re-parses and re-builds the SAH BVH on the
host (runtime/animation.py -> load_scene_dict).  For keyframe animation
the topology never changes — only per-prop affine transforms — so the
whole per-frame rebuild collapses to a jitted on-device REFIT:

  1. transform the padded per-slot triangle soup (and shading frames,
     light tris) by each prop's delta affine vs the base frame;
  2. recompute leaf AABBs and sweep them up the (static) binary tree,
     one level at a time (depth-grouped scatter/gathers);
  3. rewrite the packed wide-node child boxes in place through the
     wide-child -> binary-node map recorded at pack time
     (ops/packing.PackedBVH.wide_child_bin) and re-emit the packed leaf
     triangle rows.

Hit results are identical to a full rebuild (both trees bound the same
geometry; the refit tree keeps base-frame topology, so its SAH quality
degrades gracefully with large motions — the standard refit trade-off),
and no host round-trip or recompilation happens per frame: the arrays
pytree keeps its shapes, so the renderer's jitted step is reused as-is.
What the refit saves per frame on the GPU is not measured yet.

Delta affines are derived by probing the SAME host transform pipeline the
scene compiler uses (scene/transforms.apply_prop_transforms), so refit
frames match rebuild frames exactly for rigid+uniform-scale animation
(the only kind the schema's keyframes express).  Scenes using `normalize`
(global recenter/rescale from per-frame bounds, main.js:337-348) are
rejected — their frames are not transform-only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from fspt_tpu.core.vec import V3
from fspt_tpu.ops.packing import BIG
from fspt_tpu.scene.transforms import apply_prop_transforms

# float32 products on the GPU may run in TF32 (about 3 decimal digits)
# unless asked otherwise, which would move refitted boxes and triangles
# off the host rebuild's
_HIGHEST = "highest"


class RefitAux(NamedTuple):
    """Static (host-built, per-scene) structure for the on-device refit."""

    slot_prop: np.ndarray        # (S,) i32 prop id per padded slot (pad=0)
    slot_valid: np.ndarray       # (S,) bool — real triangle, not padding
    levels: Tuple[np.ndarray, ...]   # internal binary ids, deepest first
    leaf_ids: np.ndarray         # (L,) i32 binary ids of leaf nodes
    leaf_ord: np.ndarray         # (L,) i32 leaf ordinal (tri_offset/leaf)
    wide_child_bin: np.ndarray   # (Wn, width) i32 (-1 empty)
    width: int
    leaf_size: int
    base_affine: np.ndarray      # (P, 3, 4) f64 base-frame prop affines


def prop_affine(prop: dict, world_transforms=None) -> np.ndarray:
    """(3, 4) affine [M | t] of a prop's transform chain, derived by
    probing the scene compiler's own pipeline so refit and rebuild agree
    bit-for-bit on the math."""
    probe = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                      [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    out = apply_prop_transforms(probe, prop.get("rotate", []),
                                prop.get("scale", 1.0),
                                prop.get("translate", [0.0, 0.0, 0.0]),
                                world_transforms)
    t = out[0]
    M = (out[1:] - t).T                      # columns = images of e_i
    return np.concatenate([M, t[:, None]], axis=1)


def build_refit_aux(scene) -> RefitAux:
    """Derive the static refit structure from a compiled Scene."""
    if scene.build is None:
        raise ValueError("scene has no build products (constructed "
                         "outside load_scene_dict); refit unavailable")
    if scene.build["normalized"]:
        raise ValueError("scenes with `normalize` recenter/rescale from "
                         "per-frame bounds; frames are not transform-only "
                         "— use the full rebuild path")
    a = scene.arrays
    slot_tri = scene.build["slot_tri"]
    tri_prop = scene.build["tri_prop"]
    valid = slot_tri >= 0
    slot_prop = np.where(valid, tri_prop[np.maximum(slot_tri, 0)],
                         0).astype(np.int32)

    left = np.asarray(a.node_left)
    right = np.asarray(a.node_right)
    tri = np.asarray(a.node_tri)
    n = len(left)
    depth = np.zeros(n, np.int32)
    order = [0]
    for i in order:                          # BFS (preorder ids)
        if tri[i] < 0:
            depth[left[i]] = depth[i] + 1
            depth[right[i]] = depth[i] + 1
            order.append(int(left[i]))
            order.append(int(right[i]))
    internal = np.nonzero(tri < 0)[0]
    levels = tuple(
        internal[depth[internal] == d].astype(np.int32)
        for d in range(int(depth.max()) if n > 1 else 0, -1, -1)
        if np.any(depth[internal] == d))
    leaf_ids = np.nonzero(tri >= 0)[0].astype(np.int32)
    leaf_ord = (tri[leaf_ids] // scene.leaf_size).astype(np.int32)
    return RefitAux(
        slot_prop=slot_prop, slot_valid=valid, levels=levels,
        leaf_ids=leaf_ids, leaf_ord=leaf_ord,
        wide_child_bin=scene.build["wide_child_bin"],
        width=scene.meta.bvh_width, leaf_size=scene.leaf_size,
        base_affine=np.zeros((scene.build["n_props"], 3, 4)))


def delta_affines(base_props, frame_props, world_transforms=None):
    """(P, 3, 3) matrices + (P, 3) translations mapping base-frame
    geometry to frame geometry: D = A_f o A_base^{-1}."""
    mats, trans = [], []
    for pb, pf in zip(base_props, frame_props):
        Ab = prop_affine(pb, world_transforms)
        Af = prop_affine(pf, world_transforms)
        Mb, tb = Ab[:, :3], Ab[:, 3]
        Mf, tf = Af[:, :3], Af[:, 3]
        D = Mf @ np.linalg.inv(Mb)
        mats.append(D)
        trans.append(tf - D @ tb)
    return (np.asarray(mats, np.float32), np.asarray(trans, np.float32))


def refit_arrays(arrays, meta, aux: RefitAux, mats, trans):
    """Jittable: new SceneArrays with transformed geometry + refit BVH.

    arrays: base-frame SceneArrays (device); mats (P, 3, 3) / trans (P, 3)
    delta affines.  Returns arrays._replace(...) with identical shapes, so
    the renderer's compiled step is reused without recompilation.
    """
    import jax.numpy as jnp

    pid = jnp.asarray(aux.slot_prop)
    valid = jnp.asarray(aux.slot_valid)
    M = jnp.asarray(mats)[pid]                       # (S, 3, 3)
    T = jnp.asarray(trans)[pid]                      # (S, 3)

    def xf_pts(p):                                   # points: M p + t
        return jnp.einsum("sij,sj->si", M, p, precision=_HIGHEST) + T

    def xf_vec(v):                                   # vectors: M v
        return jnp.einsum("sij,sj->si", M, v, precision=_HIGHEST)

    keep = valid[:, None]
    v0 = jnp.where(keep, xf_pts(arrays.tri_v0), 0.0)
    e1 = jnp.where(keep, xf_vec(arrays.tri_e1), 0.0)
    e2 = jnp.where(keep, xf_vec(arrays.tri_e2), 0.0)

    def xf_frame(v3: V3) -> V3:
        # shading-frame vectors rotate with the prop; lengths are NOT
        # renormalized — corner normals are stored area-weighted (smooth
        # mode) and the shader normalizes after barycentric mixing, so a
        # uniform scale factor cancels.  (Keyframes express rigid +
        # uniform-scale motion only, where M^-T is proportional to M.)
        v = jnp.stack([v3.x, v3.y, v3.z], axis=-1)
        out = jnp.where(keep, xf_vec(v), 0.0)
        return V3(out[:, 0], out[:, 1], out[:, 2])

    # ---- leaf AABBs -> binary-tree upward sweep ------------------------
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = jnp.minimum(jnp.minimum(v0, p1), p2)
    tmax = jnp.maximum(jnp.maximum(v0, p1), p2)
    inf = jnp.float32(BIG)
    tmin = jnp.where(keep, tmin, inf)
    tmax = jnp.where(keep, tmax, -inf)
    L = len(aux.leaf_ord)
    ls = aux.leaf_size
    lmin = tmin.reshape(L, ls, 3).min(axis=1)        # slots are leaf-ordered
    lmax = tmax.reshape(L, ls, 3).max(axis=1)

    node_min = jnp.asarray(arrays.node_min)
    node_max = jnp.asarray(arrays.node_max)
    # leaf l's binary id: slots run in leaf-ordinal order
    node_min = node_min.at[aux.leaf_ids].set(lmin[aux.leaf_ord])
    node_max = node_max.at[aux.leaf_ids].set(lmax[aux.leaf_ord])
    left = jnp.asarray(arrays.node_left)
    right = jnp.asarray(arrays.node_right)
    for ids in aux.levels:                           # deepest level first
        ids = jnp.asarray(ids)
        node_min = node_min.at[ids].set(
            jnp.minimum(node_min[left[ids]], node_min[right[ids]]))
        node_max = node_max.at[ids].set(
            jnp.maximum(node_max[left[ids]], node_max[right[ids]]))

    # ---- rewrite packed tables -----------------------------------------
    w = aux.width
    wcb = jnp.asarray(aux.wide_child_bin)            # (Wn, w)
    cvalid = wcb >= 0
    sub = jnp.maximum(wcb, 0)
    cmin = node_min[sub]                             # (Wn, w, 3)
    cmax = node_max[sub]
    cols = [jnp.where(cvalid, cmin[:, :, 0], inf),
            jnp.where(cvalid, cmin[:, :, 1], inf),
            jnp.where(cvalid, cmin[:, :, 2], inf),
            jnp.where(cvalid, cmax[:, :, 0], -inf),
            jnp.where(cvalid, cmax[:, :, 1], -inf),
            jnp.where(cvalid, cmax[:, :, 2], -inf)]
    pk_nodes = jnp.concatenate(
        cols + [jnp.asarray(arrays.pk_nodes)[:, 6 * w:]], axis=1)

    tri9 = jnp.concatenate([v0, e1, e2], axis=-1).reshape(L, ls * 9)
    pk_leaves = jnp.concatenate(
        [tri9, jnp.asarray(arrays.pk_leaves)[:, ls * 9:]], axis=1)

    # ---- lights (areas/cdf change under scaling) -----------------------
    lpid = pid[arrays.light_slot]
    Ml = jnp.asarray(mats)[lpid]
    Tl = jnp.asarray(trans)[lpid]
    lmask = (jnp.arange(arrays.light_slot.shape[0])
             < arrays.n_light_tris)[:, None]

    def lv(v3: V3, pts: bool):
        v = jnp.stack([v3.x, v3.y, v3.z], axis=-1)
        out = (jnp.einsum("sij,sj->si", Ml, v, precision=_HIGHEST)
               + (Tl if pts else 0.0))
        return jnp.where(lmask, out, v)
    nl_v0 = lv(arrays.light_v0, True)
    nl_e1 = lv(arrays.light_e1, False)
    nl_e2 = lv(arrays.light_e2, False)
    areas = 0.5 * jnp.linalg.norm(jnp.cross(nl_e1, nl_e2), axis=-1)
    areas = jnp.where(lmask[:, 0], areas, 0.0)
    total = jnp.sum(areas)
    cdf = jnp.cumsum(areas) / jnp.maximum(total, 1e-20)

    as3 = lambda a: V3(a[:, 0], a[:, 1], a[:, 2])
    return arrays._replace(
        pk_nodes=pk_nodes, pk_leaves=pk_leaves,
        tri_v0=v0, tri_e1=e1, tri_e2=e2,
        node_min=node_min, node_max=node_max,
        nrm0=xf_frame(arrays.nrm0), nrm1=xf_frame(arrays.nrm1),
        nrm2=xf_frame(arrays.nrm2),
        tan0=xf_frame(arrays.tan0), tan1=xf_frame(arrays.tan1),
        tan2=xf_frame(arrays.tan2),
        btn0=xf_frame(arrays.btn0), btn1=xf_frame(arrays.btn1),
        btn2=xf_frame(arrays.btn2),
        light_v0=as3(nl_v0), light_e1=as3(nl_e1), light_e2=as3(nl_e2),
        light_cdf=cdf.astype(jnp.float32),
        light_area=total.astype(jnp.float32),
    )
