#!/usr/bin/env python
"""Generate SCALING.md: the scaling-efficiency table (BASELINE.md's >=85%
rays/s criterion).

Runs the sharded sample step on 1/2/4/8-device meshes.  On the CI/dev box
the mesh is 8 virtual CPU devices on 2 cores, so wall-clock is
informational; the load-balance efficiency (what wall-clock reduces to on
real chips — the forward pass has no collectives) is the asserted figure.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python scripts/scaling_report.py
"""
import os
import sys

if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"   # the meter is mesh bookkeeping

import jax  # noqa: E402

from fspt_tpu.config import RenderConfig  # noqa: E402
from fspt_tpu.parallel.scaling import measure_scaling  # noqa: E402
from fspt_tpu.testing import make_test_scene  # noqa: E402


def main():
    scene = make_test_scene(subdivisions=3)
    cfg = RenderConfig(width=64, height=64, bounces=4,
                       extra_refraction_iters=2, batch_spp=1, seed=0)
    report = measure_scaling(scene, cfg, device_counts=(1, 2, 4, 8),
                             steps=2, warmup=1)
    dev = jax.devices()[0].device_kind
    out = ["# SCALING — sharded render step efficiency",
           "",
           f"Backend: {len(jax.devices())}x {dev} "
           f"(a virtual CPU mesh unless run on real devices).",
           "Workload: procedural test scene, 64x64, 4 bounces, 1 spp/step.",
           "",
           "Load-balance efficiency = total honest rays / (devices x "
           "busiest device's rays).  The forward render has no collectives",
           "(tiles are disjoint), so on real chips wall-clock scaling "
           "efficiency equals load balance up to launch jitter; wall-clock",
           "columns below are only meaningful when devices are physical.",
           "",
           "```",
           report.table(),
           "```",
           "",
           f"Efficiency at the largest mesh: "
           f"**{report.efficiency * 100:.1f}%** "
           f"(target >= 85%, asserted in tests/test_scaling.py).",
           ""]
    path = os.path.join(os.path.dirname(__file__), "..", "SCALING.md")
    with open(path, "w") as f:
        f.write("\n".join(out))
    print("\n".join(out))
    return 0 if report.efficiency >= 0.85 else 1


if __name__ == "__main__":
    sys.exit(main())
