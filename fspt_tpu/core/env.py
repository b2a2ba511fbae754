"""Environment-map lookup and HDRi importance sampling (radiance bins), SoA.

Parity with reference tracer.fs:410-434 (envColor/envSample/sampleEnv) and the
host-side bin construction in scene/envmap.py.  One deliberate deviation: the
reference bilinearly filters raw 8-bit RGBE texels *before* decoding
(tracer.fs:410-414 — mathematically wrong across exponent boundaries); we
decode on the host and filter linear radiance, which is both correct and
differentiable w.r.t. the env map.

Layout: the env map lives as three flat (H*W,) channel planes, packed
into row tables (pack_env_rows) so a bilinear lookup is a few row
gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

from fspt_tpu.core.vec import V3

M_PI = 3.14159265
M_TAU = 2.0 * M_PI
INV_PI = 1.0 / M_PI


def bilinear_wrap_x(env_rgb: V3, hw, u, v) -> V3:
    """Sample flat channel planes at continuous uv in [0,1]: REPEAT in u,
    CLAMP_TO_EDGE in v (reference main.js:174-177), texel centers at
    (i + 0.5) / N, GL LINEAR filtering.  env_rgb: V3 of (H*W,)."""
    h, w = hw
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    x1 = jnp.mod(x0 + 1, w)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    i00 = y0 * w + x0
    i10 = y0 * w + x1
    i01 = y1 * w + x0
    i11 = y1 * w + x1
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy

    # Row-packed gathers: one (N, 3) row gather per corner instead of three
    # scalar-plane gathers.  The stack is loop-invariant inside a sample
    # step; XLA CSEs it across call sites.
    rows = jnp.stack([env_rgb.x, env_rgb.y, env_rgb.z], axis=-1)
    out = (rows[i00] * w00[:, None] + rows[i10] * w10[:, None]
           + rows[i01] * w01[:, None] + rows[i11] * w11[:, None])
    return V3(out[:, 0], out[:, 1], out[:, 2])


def pack_env_rows(env_rgb: V3, hw):
    """(H*W, 6) x-neighbor-packed env table: row (y, x) holds
    [rgb(x), rgb(x+1 mod W)].  Bilinear filtering then needs TWO row
    gathers (y0 and y1) instead of four corner gathers.  Built once per
    traced sample (differentiable: its VJP
    scatters back onto the env planes, a train-step parameter)."""
    h, w = hw
    rgb = jnp.stack([env_rgb.x, env_rgb.y, env_rgb.z],
                    axis=-1).reshape(h, w, 3)
    nxt = jnp.roll(rgb, -1, axis=1)
    return jnp.concatenate([rgb, nxt], axis=-1).reshape(h * w, 6)


def env_radiance_rows(env6, hw, direction: V3, theta) -> V3:
    """env_radiance against the pack_env_rows table: 2 gathers, same
    REPEAT-u / CLAMP-v GL LINEAR semantics as bilinear_wrap_x."""
    h, w = hw
    u, v = env_uv(direction, theta)
    x = u * w - 0.5
    y = v * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    x0 = jnp.mod(x0f.astype(jnp.int32), w)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    r0 = env6[y0 * w + x0]
    r1 = env6[y1 * w + x0]
    top = r0[:, 0:3] * (1 - fx) + r0[:, 3:6] * fx
    bot = r1[:, 0:3] * (1 - fx) + r1[:, 3:6] * fx
    out = top * (1 - fy) + bot * fy
    return V3(out[:, 0], out[:, 1], out[:, 2])


def env_radiance_rows_nearest(env6, hw, direction: V3, theta) -> V3:
    """Nearest-texel radiance from the pack_env_rows table: ONE row gather
    (vs bilinear's two).  Secondary-bounce env lookups land on rough-surface paths where the
    filtering mode is visually irrelevant — the production config
    (cfg.escape_env_nearest) uses this for scatter-ray escape radiance
    while primary-miss backgrounds stay bilinear."""
    h, w = hw
    u, v = env_uv(direction, theta)
    x = jnp.mod(jnp.round(u * w - 0.5).astype(jnp.int32), w)
    y = jnp.clip(jnp.round(v * h - 0.5).astype(jnp.int32), 0, h - 1)
    r = env6[y * w + x]
    return V3(r[:, 0], r[:, 1], r[:, 2])


def sample_env_bins_radiance(bins, env6, n_bins, env_hw, theta,
                             u1, u2, u3):
    """sample_env_bins fused with the sampled texel's radiance: the bin
    draw already knows the continuous image point (px, py) it sampled, so
    the NEE radiance is ONE nearest row gather on the pack_env_rows table
    — no direction->equirect inverse (atan2/asin) and one gather instead
    of bilinear's two (round-5 shading-gather fusion, PERF.md lever 1).
    Consistent MC estimator: radiance is evaluated at the very texel the
    pdf describes.  Returns (dir V3, pdf, radiance V3)."""
    h, w = env_hw
    nb = n_bins.astype(jnp.float32)
    idx = jnp.clip((nb * u1).astype(jnp.int32), 0, n_bins - 1)
    b = bins[idx]
    x0 = b[:, 0]
    y0 = b[:, 1]
    bw = b[:, 2] - x0
    bh = b[:, 3] - y0
    px = bw * u2 + x0
    py = bh * u3 + y0
    u = (-theta) + px / w
    v = py / h
    th = u * M_TAU
    phi = v * M_PI
    sin_phi = jnp.sin(phi)
    direction = V3(jnp.cos(th) * sin_phi, jnp.cos(phi),
                   jnp.sin(th) * sin_phi)
    nominal = (w * h) / nb
    pdf = nominal / jnp.maximum(bw * bh * M_TAU * M_PI * sin_phi, 1e-12)
    xi = jnp.mod(px.astype(jnp.int32), w)
    yi = jnp.clip(py.astype(jnp.int32), 0, h - 1)
    r = env6[yi * w + xi]
    return direction, pdf, V3(r[:, 0], r[:, 1], r[:, 2])


def env_uv(direction: V3, theta):
    """Equirect direction -> uv (tracer.fs:416-418):
    u = theta + atan2(z, x) / tau  (wraps),  v = asin(-y)/pi + 0.5."""
    u = theta + jnp.arctan2(direction.z, direction.x) / M_TAU
    v = jnp.arcsin(jnp.clip(-direction.y, -1.0, 1.0)) * INV_PI + 0.5
    return u, v


def env_radiance(env_rgb: V3, hw, direction: V3, theta) -> V3:
    """V3 of (N,) radiance for V3 (N,) directions."""
    u, v = env_uv(direction, theta)
    return bilinear_wrap_x(env_rgb, hw, u, v)


def sample_env_bins(bins, n_bins, env_hw, theta, u1, u2, u3):
    """Draw env directions from the radiance bins (tracer.fs:421-434).

    bins: 4-tuple of flat (B,) planes [x0, y0, x1, y1] in pixels, or one
    (B, 4) row table (one gather instead of four); n_bins: traced scalar; env_hw: static (H, W).
    Returns (dir V3 (N,), pdf (N,)).
    """
    h, w = env_hw
    nb = n_bins.astype(jnp.float32)
    idx = jnp.clip((nb * u1).astype(jnp.int32), 0, n_bins - 1)
    if isinstance(bins, tuple):
        bx0, by0, bx1, by1 = bins
        x0 = bx0[idx]
        y0 = by0[idx]
        bw = bx1[idx] - x0
        bh = by1[idx] - y0
    else:
        b = bins[idx]
        x0 = b[:, 0]
        y0 = b[:, 1]
        bw = b[:, 2] - x0
        bh = b[:, 3] - y0
    u = (-theta) + (bw * u2 + x0) / w
    v = (bh * u3 + y0) / h
    th = u * M_TAU
    phi = v * M_PI
    sin_phi = jnp.sin(phi)
    direction = V3(jnp.cos(th) * sin_phi, jnp.cos(phi), jnp.sin(th) * sin_phi)
    nominal = (w * h) / nb
    pdf = nominal / jnp.maximum(bw * bh * M_TAU * M_PI * sin_phi, 1e-12)
    return direction, pdf
