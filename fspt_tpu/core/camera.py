"""Primary-ray generation: pinhole basis + anti-alias jitter + thin-lens DOF.

Parity with reference shader/camera.fs: basis from view dir x world-up
(:39-41), screen point at unit distance scaled by fovScale (:21-24), AA jitter
uniform disk of radius sqrt(2) px (:26-30), thin-lens DOF with
lens_x = 1 - 1/focal_depth (:32-35,:44-45; encoding main.js:74).

Rays are produced directly in SoA form (V3 of flat (N,) planes);
no (N, 3) array ever exists on the hot path.

Image convention: row 0 = top of image; GL's bottom-up fragment coords are
absorbed into the v flip here.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from fspt_tpu.core.vec import V3, cross, normalize

M_PI = 3.14159265
M_TAU = 2.0 * M_PI


def camera_basis(direction):
    """basisX/basisY from view dir and world-up (camera.fs:39-41).
    direction: (3,) array. Returns (i, bx, by) as V3 of scalars."""
    d = jnp.asarray(direction, jnp.float32)
    i = V3(d[0], d[1], d[2])
    up = V3(jnp.float32(0), jnp.float32(1), jnp.float32(0))
    bx = normalize(cross(i, up))
    by = normalize(cross(bx, i))
    return i, bx, by


def generate_rays(position, direction, fov_scale, focal_depth, aperture,
                  resolution: Tuple[int, int], uniforms, pixel_idx=None):
    """Primary rays for every pixel, SoA.

    position/direction: (3,) arrays.  resolution: (width, height) static.
    uniforms: (4, N) in [0,1) — AA angle, AA radius, DOF angle, DOF radius.
    pixel_idx: optional (N,) i32 row-major pixel ids (sharded/tiled callers).
    Returns (origin V3, dir V3) of (N,) planes.
    """
    width, height = resolution
    p = jnp.asarray(position, jnp.float32)
    pos = V3(p[0], p[1], p[2])
    i, bx, by = camera_basis(direction)

    if pixel_idx is None:
        n = width * height
        pixel_idx = jnp.arange(n, dtype=jnp.int32)
    px = (pixel_idx % width).astype(jnp.float32)
    py = (pixel_idx // width).astype(jnp.float32)
    uvx = (px + 0.5) / width * 2.0 - 1.0
    uvy = 1.0 - (py + 0.5) / height * 2.0

    aspect = width / height
    screen = (bx * (uvx * fov_scale * aspect) + by * (uvy * fov_scale)
              + i + pos)

    theta_aa = uniforms[0] * M_TAU
    r_aa = jnp.sqrt(uniforms[1]) * 1.414
    aa = (bx * (r_aa * jnp.cos(theta_aa) / width)
          + by * (r_aa * jnp.sin(theta_aa) / height)) * fov_scale

    theta_dof = uniforms[2] * M_TAU
    r_dof = jnp.sqrt(uniforms[3]) * aperture
    dof = bx * (jnp.cos(theta_dof) * r_dof) + by * (jnp.sin(theta_dof) * r_dof)

    lens_x = 1.0 - 1.0 / focal_depth
    origin = pos + dof
    d = normalize(screen + aa + dof * lens_x - origin)
    return origin, d
