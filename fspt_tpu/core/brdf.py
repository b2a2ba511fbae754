"""UE4-style microfacet BRDF: GGX/GTR2 + Smith G + Schlick Fresnel, metallic
workflow, plus cosine-weighted Lambert — sampling, eval, and pdfs.  SoA.

Parity with reference tracer.fs:205-298 (gtr2, smithG, gtr2Pdf, lambertPdf,
schlick with total internal reflection, sampleMicrofacet, sampleLambert,
evalSpecular, evalLambert, cosineSampleHemisphere) and the power-heuristic
misWeights (tracer.fs:194-203).

All functions are elementwise over flat (N,) planes (V3 for vectors);
random numbers are passed in explicitly (counter-based keys live in the
integrator).
"""

from __future__ import annotations

import jax.numpy as jnp

from fspt_tpu.core.vec import V3, cross, dot, normalize, where

M_PI = 3.14159265
M_TAU = 2.0 * M_PI
INV_PI = 1.0 / M_PI


def _sqrt0(x):
    """sqrt(max(x, 0)) with gradient 0 where x <= 0.  The plain form's
    gradient there is inf * 0 = NaN, which reaches the parameter gradients
    (e.g. a GGX sample whose cos_theta rounds to 1 poisons d/d roughness)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def onb(normal: V3):
    """Orthonormal basis about `normal` — up-vector trick matching
    tracer.fs:259-261/275-277: up = |n.z| < 0.999 ? z : x."""
    nz_ok = jnp.abs(normal.z) < 0.999
    zero = jnp.zeros_like(normal.x)
    one = jnp.ones_like(normal.x)
    up = V3(jnp.where(nz_ok, zero, one), zero, jnp.where(nz_ok, one, zero))
    tangent = normalize(cross(up, normal))
    bitangent = cross(normal, tangent)
    return tangent, bitangent


def gtr2(ndh, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndh * ndh
    return a2 / (M_PI * t * t)


def smith_g(ndv, alpha_g):
    """Smith geometric shadowing (tracer.fs:221-224) with one deliberate
    deviation: the reference returns 1/(ndv + sqrt(...)), which for a
    backfacing direction (ndv <= 0, reachable through GGX-tail micro
    normals) divides by ~0 — the +inf then rides into
    `evalSpecular(...) * clamp(ndl, 0, 1)` (tracer.fs:479) as inf * 0 = NaN
    and poisons the pixel's accumulator forever.  A fully shadowed
    direction transmits nothing, so return 0 there instead."""
    a = alpha_g * alpha_g
    b = ndv * ndv
    denom = ndv + _sqrt0(a + b - a * b)
    return jnp.where(denom > 1e-7, 1.0 / jnp.maximum(denom, 1e-7), 0.0)


def gtr2_pdf(incident: V3, normal: V3, roughness, bsdf_dir: V3):
    """pdf of the reflected direction under GGX half-vector sampling
    (tracer.fs:227-233)."""
    alpha = jnp.maximum(0.001, roughness)
    half = normalize(bsdf_dir + incident)
    cos_theta = jnp.abs(dot(half, normal))
    pdf_h = gtr2(cos_theta, alpha) * cos_theta
    return pdf_h / jnp.maximum(4.0 * jnp.abs(dot(bsdf_dir, half)), 1e-12)


def lambert_pdf(normal: V3, bsdf_dir: V3):
    return jnp.abs(dot(bsdf_dir, normal)) * INV_PI


def schlick(incident: V3, normal: V3, n1, n2):
    """Fresnel with total internal reflection (tracer.fs:239-254).
    n1 = medium of incident ray, n2 = other side."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_theta = dot(normal, incident)
    n = n1 / n2
    sin_theta2 = n * n * (1.0 - cos_theta * cos_theta)
    tir = (n1 > n2) & (sin_theta2 > 1.0)
    cos_theta = jnp.where(n1 > n2,
                          _sqrt0(1.0 - sin_theta2),
                          cos_theta)
    x = 1.0 - cos_theta
    f = r0 + (1.0 - r0) * x ** 5
    return jnp.where(tir, 1.0, f)


def sample_microfacet(normal: V3, roughness, u1, u2) -> V3:
    """GGX half-vector sample about `normal` (tracer.fs:256-270)."""
    tangent, bitangent = onb(normal)
    a = jnp.maximum(0.001, roughness)
    phi = u1 * M_TAU
    cos_theta = jnp.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_theta = _sqrt0(1.0 - cos_theta ** 2)
    return (tangent * (sin_theta * jnp.cos(phi))
            + bitangent * (sin_theta * jnp.sin(phi))
            + normal * cos_theta)


def sample_lambert(normal: V3, u1, u2) -> V3:
    """Cosine-weighted hemisphere about `normal` (tracer.fs:272-280,
    cosineSampleHemisphere tracer.fs:205-213)."""
    tangent, bitangent = onb(normal)
    r = jnp.sqrt(u1)
    phi = M_TAU * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - x * x - y * y))
    return tangent * x + bitangent * y + normal * z


def eval_specular(incident: V3, normal: V3, diffuse: V3, metallic,
                  roughness, bsdf_dir: V3) -> V3:
    """Gs * Fs * Ds (tracer.fs:282-294)."""
    ndl = dot(normal, bsdf_dir)
    ndv = dot(normal, incident)
    h = normalize(bsdf_dir + incident)
    ndh = dot(normal, h)
    a = jnp.maximum(0.001, roughness)
    ds = gtr2(ndh, a)
    fs = diffuse * metallic + (1.0 - metallic)
    roughg = (roughness * 0.5 + 0.5) ** 2
    gs = smith_g(ndl, roughg) * smith_g(ndv, roughg)
    return fs * (gs * ds)


def eval_lambert(diffuse: V3) -> V3:
    return diffuse * INV_PI


def mis_weights(a, b, eps: float = 1e-6):
    """Power heuristic a^2/(a^2+b^2) (tracer.fs:194-203). Returns (wa, wb);
    degenerate pdfs give (1, 0)."""
    a2 = a * a
    b2 = b * b
    denom = a2 + b2
    ok = (a > eps) & (b > eps)
    wa = jnp.where(ok, a2 / jnp.where(ok, denom, 1.0), 1.0)
    wb = jnp.where(ok, b2 / jnp.where(ok, denom, 1.0), 0.0)
    return wa, wb


def reflect(incident_neg: V3, n: V3) -> V3:
    """GLSL reflect(I, N) = I - 2 dot(N, I) N."""
    return incident_neg - n * (2.0 * dot(n, incident_neg))


def refract(incident_neg: V3, n: V3, eta) -> V3:
    """GLSL refract(I, N, eta); returns 0-vector on TIR (never selected —
    TIR forces the specular branch via schlick == 1, tracer.fs:487)."""
    ndi = dot(n, incident_neg)
    k = 1.0 - eta * eta * (1.0 - ndi * ndi)
    tir = k < 0.0
    out = incident_neg * eta - n * (eta * ndi + _sqrt0(k))
    zero = V3(jnp.zeros_like(out.x), jnp.zeros_like(out.y),
              jnp.zeros_like(out.z))
    return where(tir, zero, out)
