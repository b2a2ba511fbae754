"""Scene JSON ingestion, material resolution, and flattening into the
device-side `SceneArrays` pytree.

This replaces the reference's texture/uniform upload contract
(reference main.js:284-445 initBVH: six padded RGB32F textures + one
TEXTURE_2D_ARRAY atlas + uniform arrays) with a single pytree of plain device
arrays — the part of the reference SURVEY.md says to *replace*, not replicate.

Layout rules:
  * per-slot shading attributes are FLAT (S,) planes, stacked into row
    tables once per traced sample (core/integrator._attr_table)
  * the BVH is packed into wide-node row tables for the traversal
    (ops/packing.py, ops/bvh.py)

Scene JSON schema parity (reference README + main.js:51-75,915-950):
  environment (path | gradient stops), environmentTheta, cameraPos, cameraDir,
  fovScale, exposure, samples, atlasRes, normalize, worldTransforms,
  props / static_props / animated_props, each prop with: path, scale, rotate,
  translate, diffuse, emittance, metallicRoughness, mrSwizzle, ior,
  dielectric, normal, emission, normals, skips.

Material resolution precedence (reference main.js:206-270 getMaterial):
  MTL map > MTL color > scene-prop map > scene-prop color > default, with
  defaults diffuse [.5,.5,.5], metallicRoughness [0,.3,0],
  normal [.5,.5,1], emissive [0,0,0], ior 1.4, dielectric -1.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from fspt_tpu.config import CameraConfig, PostConfig
from fspt_tpu.core.vec import V3
from fspt_tpu.ops.packing import pack_bvh
from fspt_tpu.scene import envmap
from fspt_tpu.scene.atlas import TexturePacker
from fspt_tpu.scene.bvh import BVHArrays, build_bvh, triangle_aabbs
from fspt_tpu.scene.mtl import parse_mtl
from fspt_tpu.scene.obj import MeshGroup, parse_obj


def _v3(a, col_major=False):
    """(K, 3) -> V3 of contiguous flat (K,) planes."""
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return V3(a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy())


class SceneArrays(NamedTuple):
    """Everything the device-side integrator needs, as one pytree.

    S = padded triangle slots (leaf-ordered, multiples of leaf_size),
    B = env-bin capacity, Lt = light triangles.
    """

    # --- Pallas packet-traversal tables (ops/packing.py layout) ---
    pk_nodes: np.ndarray        # (R, 128) f32
    pk_leaves: np.ndarray       # (L, 128) f32
    # --- per-slot shading attributes, flat (S,) planes ---
    nrm0: V3                    # corner shading normals
    nrm1: V3
    nrm2: V3
    tan0: V3
    tan1: V3
    tan2: V3
    btn0: V3
    btn1: V3
    btn2: V3
    uv0u: np.ndarray            # (S,)
    uv0v: np.ndarray
    uv1u: np.ndarray
    uv1v: np.ndarray
    uv2u: np.ndarray
    uv2v: np.ndarray
    map_d: np.ndarray           # (S,) i32 atlas layer: diffuse
    map_e: np.ndarray           # (S,) i32: emissive
    map_n: np.ndarray           # (S,) i32: normal
    map_mr: np.ndarray          # (S,) i32: metallicRoughness
    # Combined-material indirection: map_c[s] indexes mat_layers, whose row
    # is that material's (diffuse, emissive, normal, mr) atlas layers.  The
    # integrator packs the four maps' texels into one row table at trace
    # time so a shading point costs 2 row gathers instead of 16
    # (core/integrator._packed_tables).
    map_c: np.ndarray           # (S,) i32 combined-material id
    mat_layers: np.ndarray      # (U, 4) i32 source atlas layers per id
    emit: V3                    # per-slot constant emittance
    ior: np.ndarray             # (S,)
    dielectric: np.ndarray      # (S,)
    # --- textures, flat channel planes ---
    atlas_r: np.ndarray         # (L*R*R,) premultiplied linear
    atlas_g: np.ndarray
    atlas_b: np.ndarray
    env_rgb: V3                 # (H*W,) linear radiance
    bin_x0: np.ndarray          # (B,) env radiance-bin boxes, pixels
    bin_y0: np.ndarray
    bin_x1: np.ndarray
    bin_y1: np.ndarray
    n_bins: np.ndarray          # () i32 — actual bin count <= B
    env_theta: np.ndarray       # () f32
    # --- area lights (emissive groups; reference main.js:394-406) ---
    light_v0: V3                # (Lt,) planes
    light_e1: V3
    light_e2: V3
    light_slot: np.ndarray      # (Lt,) i32 — slot index for material lookup
    light_cdf: np.ndarray       # (Lt,) f32 — area-weighted CDF (ends at 1)
    light_area: np.ndarray      # () f32 — total light surface area
    n_light_tris: np.ndarray    # () i32
    # --- oracle / autofocus geometry (AoS; tests and single-ray paths) ---
    tri_v0: np.ndarray          # (S, 3) f32
    tri_e1: np.ndarray          # (S, 3) f32
    tri_e2: np.ndarray          # (S, 3) f32
    node_left: np.ndarray       # (M,) i32
    node_right: np.ndarray      # (M,) i32
    node_tri: np.ndarray        # (M,) i32 (slot offset, -1 internal)
    node_min: np.ndarray        # (M, 3) f32
    node_max: np.ndarray        # (M, 3) f32


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static shape metadata (hashable; closed over by jitted steps — the
    analog of the reference's injected #defines, main.js:873-877)."""

    env_h: int
    env_w: int
    atlas_res: int
    atlas_layers: int
    leaf_size: int
    # traversal stack bound (ops/bvh.py), sized from the wide tree depth
    # at pack time (ops/packing.py): max ptr <= w * (depth + 2)
    pk_stack_depth: int = 64
    # wide-BVH branching factor of the packed tables (8 or 16); 8 is the
    # default, which width is faster on the GPU is not measured yet.
    bvh_width: int = 8


@dataclasses.dataclass
class Scene:
    """Host-side compiled scene: arrays + defaults + build metadata."""

    arrays: SceneArrays
    meta: SceneMeta
    camera: CameraConfig
    post: PostConfig
    samples: int
    num_triangles: int
    bvh_depth: int
    leaf_size: int
    name: str = "scene"
    # host-side build products (slot_tri / tri_prop / wide_child_bin /
    # normalized flag) consumed by the on-device refit (scene/refit.py);
    # None for scenes constructed outside load_scene_dict
    build: Optional[dict] = None

    def device_arrays(self, sharding=None):
        import jax
        arrs = self.arrays
        if sharding is None:
            return jax.tree.map(jax.numpy.asarray, arrs)
        return jax.device_put(arrs, sharding)


class AssetLoader:
    """Resolves scene-relative asset paths (the reference fetches over HTTP,
    reference utility.js:1-53; here it is the filesystem)."""

    def __init__(self, root: str):
        self.root = root

    def text(self, path: str) -> str:
        with open(os.path.join(self.root, path), "r") as f:
            return f.read()

    def image(self, path: str) -> np.ndarray:
        from fspt_tpu.io.image import pil_image_module
        with pil_image_module().open(os.path.join(self.root, path)) as im:
            return np.asarray(im.convert("RGBA"))

    def exists(self, path: str) -> bool:
        return os.path.exists(os.path.join(self.root, path))


def merge_scene_props(scene: dict) -> List[dict]:
    """props + static_props + animated_props values (main.js:869-871)."""
    out = list(scene.get("props") or [])
    out += list(scene.get("static_props") or [])
    animated = scene.get("animated_props") or {}
    if isinstance(animated, dict):
        out += list(animated.values())
    else:
        out += list(animated)
    return out


def _prop_defaults(prop: dict) -> dict:
    p = dict(prop)
    p.setdefault("scale", 1.0)
    p.setdefault("rotate", [])
    p.setdefault("translate", [0.0, 0.0, 0.0])
    p.setdefault("emittance", [0.0, 0.0, 0.0])
    return p


@dataclasses.dataclass
class _ResolvedMaterial:
    diffuse_idx: int
    emissive_idx: int   # reference calls this "specular"/kem slot
    normal_idx: int
    mr_idx: int
    ior: float
    dielectric: float
    emittance: Sequence[float]


def _resolve_material(prop: dict, group: MeshGroup, packer: TexturePacker,
                      loader: AssetLoader, base_path: str) -> _ResolvedMaterial:
    """Reference main.js:206-270 getMaterial."""
    m = group.material or {}

    def img(path, corrected=False, swizzle=None):
        return packer.add_texture(loader.image(path), key=path,
                                  corrected=corrected, swizzle=swizzle)

    if m.get("map_kd"):
        diffuse = img(m["map_kd"], corrected=True)
    elif m.get("kd"):
        diffuse = packer.add_color(m["kd"][:3])
    elif isinstance(prop.get("diffuse"), str):
        diffuse = img(prop["diffuse"], corrected=True)
    elif isinstance(prop.get("diffuse"), (list, tuple)):
        diffuse = packer.add_color(prop["diffuse"][:3])
    else:
        diffuse = packer.add_color([0.5, 0.5, 0.5])

    if m.get("map_pmr"):
        sw = m.get("pmr_swizzle")
        mr = img(m["map_pmr"], swizzle=[int(x) for x in sw] if sw else None)
    elif m.get("pmr"):
        mr = packer.add_color(m["pmr"][:3])
    elif isinstance(prop.get("metallicRoughness"), str):
        sw = prop.get("mrSwizzle")
        mr = img(prop["metallicRoughness"],
                 swizzle=[int(x) for x in sw] if sw else None)
    elif isinstance(prop.get("metallicRoughness"), (list, tuple)):
        mr = packer.add_color(prop["metallicRoughness"][:3])
    else:
        mr = packer.add_color([0.0, 0.3, 0.0])

    if m.get("map_kem"):
        emissive = img(m["map_kem"])
    elif m.get("kem"):
        emissive = packer.add_color(m["kem"][:3])
    elif isinstance(prop.get("emission"), str):
        emissive = img(prop["emission"])
    else:
        emissive = packer.add_color([0.0, 0.0, 0.0])

    if m.get("map_bump"):
        normal = img(m["map_bump"])
    elif prop.get("normal"):
        normal = img(prop["normal"])
    else:
        normal = packer.add_color([0.5, 0.5, 1.0])

    return _ResolvedMaterial(
        diffuse_idx=diffuse, emissive_idx=emissive, normal_idx=normal,
        mr_idx=mr,
        ior=float(m.get("ior") or prop.get("ior") or 1.4),
        dielectric=float(m.get("dielectric") or prop.get("dielectric") or -1.0),
        emittance=prop.get("emittance", [0.0, 0.0, 0.0]),
    )


def load_scene_file(path: str, leaf_size: int = 8,
                    env_bins_cap: int = 256, builder: str = "auto",
                    bvh_width: int = 8) -> Scene:
    root = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        scene = json.load(f)
    return load_scene_dict(scene, AssetLoader(root), leaf_size=leaf_size,
                           env_bins_cap=env_bins_cap, builder=builder,
                           bvh_width=bvh_width,
                           name=os.path.splitext(os.path.basename(path))[0])


# above this, "auto" switches from the full-sweep oracle builder to the
# binned-SAH one (native C++ when a compiler exists, scene/fastbvh.py)
_FAST_BUILD_THRESHOLD = 4096


def load_scene_dict(scene: dict, loader: AssetLoader, leaf_size: int = 8,
                    env_bins_cap: int = 256, name: str = "scene",
                    builder: str = "auto", bvh_width: int = 8) -> Scene:
    # ---- environment ----------------------------------------------------
    env_spec = scene.get("environment")
    if isinstance(env_spec, str):
        rgbe = loader.image(env_spec)
        env = envmap.decode_rgbe(rgbe)
        bins = envmap.compute_radiance_bins(env)
    elif isinstance(env_spec, (list, tuple)):
        env = envmap.gradient_environment(env_spec)
        bins = envmap.single_bin(env.shape[1], env.shape[0])
    else:
        env = envmap.gradient_environment([[0, 0, 0], [0, 0, 0]])
        bins = envmap.single_bin(env.shape[1], env.shape[0])

    # ---- props -> triangle soup ----------------------------------------
    packer = TexturePacker(int(scene.get("atlasRes", 2048)))
    props = [_prop_defaults(p) for p in merge_scene_props(scene)]
    world_transforms = scene.get("worldTransforms")

    all_groups: List[MeshGroup] = []
    group_mats: List[_ResolvedMaterial] = []
    light_group_ids: List[int] = []
    prop_of_group: List[int] = []
    for prop_idx, prop in enumerate(props):
        base_path = os.path.dirname(prop["path"])
        parsed = parse_obj(loader.text(prop["path"]), prop, world_transforms)
        materials: Dict[str, dict] = {}
        if parsed.mtllib:
            mtl_path = f"{base_path}/{parsed.mtllib}" if base_path else parsed.mtllib
            materials, _ = parse_mtl(loader.text(mtl_path), base_path)
        is_light = float(np.dot(prop["emittance"], [1, 1, 1])) > 0
        for group in parsed.groups:
            group.material = materials.get(group.name, {})
            mat = _resolve_material(prop, group, packer, loader, base_path)
            if is_light:
                light_group_ids.append(len(all_groups))
            all_groups.append(group)
            group_mats.append(mat)
            prop_of_group.append(prop_idx)

    if not all_groups:
        raise ValueError("scene contains no geometry")

    verts = np.concatenate([g.verts for g in all_groups], axis=0)
    nrm = np.concatenate([g.normals for g in all_groups], axis=0)
    tan = np.concatenate([g.tangents for g in all_groups], axis=0)
    btn = np.concatenate([g.bitangents for g in all_groups], axis=0)
    uv = np.concatenate([g.uvs for g in all_groups], axis=0)

    group_sizes = [len(g.verts) for g in all_groups]
    group_of_tri = np.repeat(np.arange(len(all_groups)), group_sizes)
    offsets = np.concatenate([[0], np.cumsum(group_sizes)])

    # ---- optional normalize: recenter + rescale (main.js:337-348) ------
    if scene.get("normalize"):
        bmin = verts.reshape(-1, 3).min(axis=0)
        bmax = verts.reshape(-1, 3).max(axis=0)
        longest = float((bmax - bmin).max())
        centroid = 0.5 * (bmin + bmax)
        scale = 2.0 * float(scene["normalize"]) / longest
        verts = (verts - centroid) * scale

    # ---- BVH + slot ordering -------------------------------------------
    tri_min, tri_max = triangle_aabbs(verts)
    if builder == "auto":
        builder = ("binned" if len(verts) > _FAST_BUILD_THRESHOLD
                   else "sweep")
    if builder == "binned":
        from fspt_tpu.scene.fastbvh import build_bvh_fast
        bvh: BVHArrays = build_bvh_fast(tri_min, tri_max, leaf_size=leaf_size)
    elif builder == "sweep":
        bvh = build_bvh(tri_min, tri_max, leaf_size=leaf_size)
    else:
        raise ValueError(f"unknown builder {builder!r}")

    slot = bvh.slot_tri                      # (S,) original tri index or -1
    pad = slot < 0
    gather = np.where(pad, 0, slot)

    v = verts[gather].astype(np.float32)
    v[pad] = 0.0
    tri_v0 = v[:, 0]
    tri_e1 = v[:, 1] - v[:, 0]
    tri_e2 = v[:, 2] - v[:, 0]

    pk = pack_bvh(bvh.left, bvh.right, bvh.tri_offset, bvh.node_min,
                  bvh.node_max, tri_v0, tri_e1, tri_e2, leaf_size=leaf_size,
                  width=bvh_width)

    def corner(a, c):
        """(T, 3corners, 3) attr -> padded (S, 3) for corner c."""
        out = a[gather, c].astype(np.float32)
        out[pad] = 0.0
        return out

    mats_per_group = np.array(
        [[m.diffuse_idx, m.emissive_idx, m.normal_idx, m.mr_idx]
         for m in group_mats], dtype=np.int32)
    emit_per_group = np.array([m.emittance[:3] for m in group_mats],
                              dtype=np.float32)
    ior_per_group = np.array([m.ior for m in group_mats], dtype=np.float32)
    diel_per_group = np.array([m.dielectric for m in group_mats],
                              dtype=np.float32)

    slot_group = group_of_tri[gather]
    mat_maps = mats_per_group[slot_group]
    mat_maps[pad] = 0
    # combined-material ids: unique (d, e, n, mr) layer tuples over slots
    mat_layers, map_c = np.unique(mat_maps, axis=0, return_inverse=True)
    mat_layers = mat_layers.astype(np.int32)
    map_c = map_c.astype(np.int32)
    mat_emit = emit_per_group[slot_group]
    mat_emit[pad] = 0.0
    mat_ior = ior_per_group[slot_group]
    mat_ior[pad] = 1.0
    mat_diel = diel_per_group[slot_group]
    mat_diel[pad] = -1.0

    uv_s = uv[gather].astype(np.float32)
    uv_s[pad] = 0.0

    # ---- lights ---------------------------------------------------------
    lv0, le1, le2, lslot = [], [], [], []
    tri_to_slot = np.full(len(verts), -1, dtype=np.int64)
    tri_to_slot[gather] = np.arange(len(gather))
    for gid in light_group_ids:
        ids = np.arange(offsets[gid], offsets[gid + 1])
        gv = verts[ids]
        lv0.append(gv[:, 0])
        le1.append(gv[:, 1] - gv[:, 0])
        le2.append(gv[:, 2] - gv[:, 0])
        lslot.append(tri_to_slot[ids])
    if lv0:
        light_v0 = np.concatenate(lv0).astype(np.float32)
        light_e1 = np.concatenate(le1).astype(np.float32)
        light_e2 = np.concatenate(le2).astype(np.float32)
        light_slot = np.concatenate(lslot).astype(np.int32)
    else:
        light_v0 = np.zeros((1, 3), np.float32)
        light_e1 = np.zeros((1, 3), np.float32)
        light_e2 = np.zeros((1, 3), np.float32)
        light_slot = np.zeros((1,), np.int32)
    areas = 0.5 * np.linalg.norm(np.cross(light_e1, light_e2), axis=1)
    light_area = float(areas.sum())
    light_cdf = (np.cumsum(areas) / max(light_area, 1e-20)).astype(np.float32)

    # ---- env bins (padded to static capacity) --------------------------
    boxes = bins.boxes
    if len(boxes) > env_bins_cap:
        raise ValueError(
            f"scene produced {len(boxes)} env bins > cap {env_bins_cap}; "
            "raise env_bins_cap")
    padded_bins = np.zeros((env_bins_cap, 4), dtype=np.float32)
    padded_bins[: len(boxes)] = boxes.astype(np.float32)
    if len(boxes) < env_bins_cap:   # repeat last bin into padding (unsampled)
        padded_bins[len(boxes):] = boxes[-1].astype(np.float32)

    # ---- flat texture planes -------------------------------------------
    atlas = packer.pack()                         # (L, R, R, 4) f32
    atlas_flat = atlas.reshape(-1, 4)
    env_f = env.astype(np.float32).reshape(-1, 3)

    arrays = SceneArrays(
        pk_nodes=pk.nodes, pk_leaves=pk.leaves,
        nrm0=_v3(corner(nrm, 0)), nrm1=_v3(corner(nrm, 1)),
        nrm2=_v3(corner(nrm, 2)),
        tan0=_v3(corner(tan, 0)), tan1=_v3(corner(tan, 1)),
        tan2=_v3(corner(tan, 2)),
        btn0=_v3(corner(btn, 0)), btn1=_v3(corner(btn, 1)),
        btn2=_v3(corner(btn, 2)),
        uv0u=uv_s[:, 0, 0].copy(), uv0v=uv_s[:, 0, 1].copy(),
        uv1u=uv_s[:, 1, 0].copy(), uv1v=uv_s[:, 1, 1].copy(),
        uv2u=uv_s[:, 2, 0].copy(), uv2v=uv_s[:, 2, 1].copy(),
        map_d=mat_maps[:, 0].copy(), map_e=mat_maps[:, 1].copy(),
        map_n=mat_maps[:, 2].copy(), map_mr=mat_maps[:, 3].copy(),
        map_c=map_c, mat_layers=mat_layers,
        emit=_v3(mat_emit), ior=mat_ior, dielectric=mat_diel,
        atlas_r=atlas_flat[:, 0].copy(), atlas_g=atlas_flat[:, 1].copy(),
        atlas_b=atlas_flat[:, 2].copy(),
        env_rgb=_v3(env_f),
        bin_x0=padded_bins[:, 0].copy(), bin_y0=padded_bins[:, 1].copy(),
        bin_x1=padded_bins[:, 2].copy(), bin_y1=padded_bins[:, 3].copy(),
        n_bins=np.int32(len(boxes)),
        env_theta=np.float32(scene.get("environmentTheta", 0.0)),
        light_v0=_v3(light_v0), light_e1=_v3(light_e1),
        light_e2=_v3(light_e2), light_slot=light_slot,
        light_cdf=light_cdf, light_area=np.float32(light_area),
        n_light_tris=np.int32(sum(len(x) for x in lv0) if lv0 else 0),
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        node_left=bvh.left, node_right=bvh.right, node_tri=bvh.tri_offset,
        node_min=bvh.node_min, node_max=bvh.node_max,
    )

    meta = SceneMeta(env_h=env.shape[0], env_w=env.shape[1],
                     atlas_res=atlas.shape[1], atlas_layers=atlas.shape[0],
                     leaf_size=leaf_size,
                     pk_stack_depth=bvh_width * (pk.depth + 2),
                     bvh_width=bvh_width)

    camera = CameraConfig(
        position=tuple(scene.get("cameraPos", [0.0, 0.0, 2.0])),
        direction=tuple(scene.get("cameraDir", [0.0, 0.0, -1.0])),
        fov_scale=float(scene.get("fovScale", 0.5)),
    )
    post = PostConfig(exposure=float(scene.get("exposure", 1.0)))

    # host-side build products for the on-device animation refit
    # (scene/refit.py): slot -> original tri, tri -> prop, and the wide
    # child <- binary-node map the packer collapsed from
    tri_prop = np.asarray(prop_of_group, np.int32)[group_of_tri]
    build = {"slot_tri": slot.astype(np.int64),
             "tri_prop": tri_prop,
             "wide_child_bin": pk.wide_child_bin,
             "n_props": len(props),
             "normalized": bool(scene.get("normalize"))}

    return Scene(
        arrays=arrays, meta=meta, camera=camera, post=post,
        samples=int(scene.get("samples", 2000)),
        num_triangles=len(verts), bvh_depth=bvh.depth, leaf_size=leaf_size,
        name=name, build=build,
    )
