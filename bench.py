#!/usr/bin/env python
"""Forward path-tracing throughput on one GPU.

Workload: a bunny-scale scene (81,922 triangles; a procedurally generated
stand-in for the brief's bunny_big.obj, which is not in the repo), 8
bounces, 8-sample wavefront batches, 512x512, production estimator config.

    python bench.py
    FSPT_BENCH_INTERSECTOR=bvh,plain python bench.py   # both, in turns

Prints one JSON line per intersector: ms/sample and active-lane rays/s
(core/integrator.TraceStats: primary + live scatter/shadow segments per
bounce), with the device JAX reports and the card's name and power limit.
Exits non-zero unless JAX's first device is a GPU: a CPU number is not a
device measurement.
"""

import json
import os
import subprocess
import sys
import time

# schedule: width divisors per bounce of the 8-sample wavefront (bench
# scene occupancy collapses after bounce 0; tail divisors are ~8x tighter
# because 8 samples' survivors share each launch)
BENCH_SCHEDULE = (1.5, 11, 48, 160, 640, 2048, 2048, 2048)


def bench_config(size: int = 512, spp: int = 8, intersector: str = "bvh"):
    """The production estimator config the bench and chip_smoke.py run."""
    from fspt_tpu.config import RenderConfig
    return RenderConfig(width=size, height=size, bounces=8,
                        extra_refraction_iters=0, batch_spp=spp,
                        compact=True, wavefront_batch=spp > 1,
                        sort_state=True, intersector=intersector,
                        nee_env_nearest=True, escape_env_nearest=True,
                        compact_schedule=BENCH_SCHEDULE)


def card_name_and_power_limit() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unavailable"


def run(scene, cfg, warmup: int, iters: int) -> dict:
    from fspt_tpu.runtime.renderer import Renderer
    r = Renderer(scene, cfg)
    t0 = time.perf_counter()
    r.step()                       # compile + 1 batch
    compile_s = time.perf_counter() - t0
    r.step(warmup)
    r._stats = {"samples": 0, "seconds": 0.0, "rays": 0.0}
    r.step(iters)
    s = r.stats
    return {"renderer": r, "compile_s": compile_s,
            "ms_per_sample": s["seconds"] / s["samples"] * 1e3,
            "rays_per_s": s["rays_per_s"]}


def main():
    card = card_name_and_power_limit()      # before JAX takes the card
    import jax
    import numpy as np

    from fspt_tpu.compile_cache import use_compile_cache
    from fspt_tpu.testing import make_bunny_standin_scene

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device {device} card: {card}", file=sys.stderr)
    if dev.platform != "gpu":
        print("bench.py measures the GPU; JAX found no GPU", file=sys.stderr)
        return 1
    use_compile_cache()

    subdiv = int(os.environ.get("FSPT_BENCH_SUBDIV", "6"))
    size = int(os.environ.get("FSPT_BENCH_SIZE", "512"))
    warmup = int(os.environ.get("FSPT_BENCH_WARMUP", "2"))
    iters = int(os.environ.get("FSPT_BENCH_ITERS", "8"))
    spp = int(os.environ.get("FSPT_BENCH_SPP", "8"))
    intersectors = os.environ.get("FSPT_BENCH_INTERSECTOR", "bvh").split(",")

    scene = make_bunny_standin_scene(subdivisions=subdiv)
    for name in intersectors:
        res = run(scene, bench_config(size, spp, name), warmup, iters)
        img = res["renderer"].hdr_image()
        print(json.dumps({
            "metric": f"ms/sample and active-lane rays/s (bunny-scale "
                      f"stand-in, {scene.num_triangles} triangles, 8 "
                      f"bounces, {spp}-sample batches, {size}x{size})",
            "intersector": name,
            "ms_per_sample": res["ms_per_sample"],
            "rays_per_s": res["rays_per_s"],
            "compile_s": res["compile_s"],
            "finite": bool(np.isfinite(img).all()),
            "device": device, "card": card}))
        m = res["renderer"].step_metrics()
        print("# per-bounce scatter occupancy: "
              + " ".join(f"{x:.3f}" for x in m["scatter_occupancy"]),
              file=sys.stderr)
        print("# per-bounce visits/lane: "
              + " ".join(f"{x:.2f}" for x in m["visits_per_lane"]),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
