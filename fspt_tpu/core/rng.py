"""Counter-based random numbers for the integrator.

The reference uses a fract(sin(seed)) hash re-seeded per pixel/hit
(tracer.fs:181,438,458) — neither deterministic across GPUs nor
checkpointable.  Here randomness is a counter hash keyed by
(base_seed, sample_index, stream, global lane): fully deterministic,
reproducible across restarts (checkpoint stores just the base seed + sample
count), and — because the lane index is explicit rather than positional —
**sharding-invariant**: a device generating only lanes [off, off+local) of a
stream reproduces exactly the values a single device generates for those
lanes.  That makes the sharded sample step (parallel/dist.py) bit-identical
to the single-device renderer, which the parallel tests assert per-pixel.

Generator choice: the per-sample key is jax.random (threefry) — one host
fold_in per sample, quality where it is cheap.  The per-lane/per-stream
values are PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) over the counter (lane, k0, k1, stream<<8|row): ~15 vectorized
u32 ops per value, instead of a threefry fold_in per lane.  PCG4D passes
the white-furnace and chi-square suites (tests/test_oracle.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sample_key(base_key, sample_index):
    return jax.random.fold_in(base_key, sample_index)


def _pcg4d(a, b, c, d):
    """PCG4D: four u32 arrays in, four decorrelated u32 arrays out."""
    mul = jnp.uint32(1664525)
    add = jnp.uint32(1013904223)
    a = a * mul + add
    b = b * mul + add
    c = c * mul + add
    d = d * mul + add
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def key_rows_for(batch_key, k: int):
    """(K, 2) u32 key-data rows for samples fold_in(batch_key, 0..K-1) —
    the per-sample keys a cross-sample wavefront batch carries so each
    lane draws ITS sample's streams (trace_paths_batched)."""
    return jax.vmap(lambda i: jax.random.key_data(
        jax.random.fold_in(batch_key, i)))(
            jnp.arange(k)).astype(jnp.uint32)


def stream_uniforms(key, stream: int, shape, lane_offset=0,
                    key_rows=None, lanes_per_key: int = 0):
    """Uniforms in [0, 1) for a numbered stream within one sample step.

    shape: (rows, n).  The value at (r, i) is a pure function of
    (key, stream, r, global lane id) — NOT of n — so shards of a larger
    lane space draw their exact slice of the single-device streams.
    lane_offset: scalar offset (lane ids = offset + arange(n)) or an (n,)
    array of explicit global lane ids (for interleaved shard assignment,
    parallel/dist.py).

    key_rows + lanes_per_key (cross-sample wavefront batching): lane id g
    belongs to sample g // lanes_per_key and hashes as (key_rows[sample],
    stream, row, g % lanes_per_key) — BIT-IDENTICAL to the value the
    unbatched estimator draws for that sample's local lane, so merging K
    samples' tails into one launch does not perturb the estimator.  `key`
    is ignored when key_rows is given.
    """
    rows, n = shape
    lane_offset = jnp.asarray(lane_offset)
    if lane_offset.ndim == 0:
        ids = lane_offset.astype(jnp.uint32) + jnp.arange(n, dtype=jnp.uint32)
    else:
        ids = lane_offset.astype(jnp.uint32)
    row = jnp.arange(rows, dtype=jnp.uint32)[:, None]
    ctr = (jnp.uint32(stream) << 8) | row                 # (rows, 1)
    if key_rows is None:
        kd = jax.random.key_data(key).astype(jnp.uint32)  # (2,)
        b = jnp.broadcast_to(kd[0], (rows, n))
        c = jnp.broadcast_to(kd[1], (rows, n))
        a = jnp.broadcast_to(ids[None, :], (rows, n))
    else:
        s = (ids // jnp.uint32(lanes_per_key)).astype(jnp.int32)
        local = ids % jnp.uint32(lanes_per_key)
        b = jnp.broadcast_to(key_rows[s, 0][None, :], (rows, n))
        c = jnp.broadcast_to(key_rows[s, 1][None, :], (rows, n))
        a = jnp.broadcast_to(local[None, :], (rows, n))
    d = jnp.broadcast_to(ctr, (rows, n))
    _, _, _, out = _pcg4d(a, b, c, d)
    # top 24 bits -> [0, 1) exactly representable in f32
    return (out >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24))
