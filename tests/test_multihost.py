"""Multi-host smoke test (round-2 VERDICT item 8): two OS processes form a
jax.distributed job on CPU, build the global mesh through
parallel/multihost.py, and run a psum'd shard_map step across processes.

This exercises the cross-process path the single-browser reference never
had (SURVEY §5): coordinator handshake, global device enumeration, and a
collective that crosses process boundaries."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fspt_tpu.parallel import multihost

port, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()          # 2 per process
assert multihost.is_coordinator() == (pid == 0)

mesh = multihost.global_mesh()
assert mesh.devices.size == 4

@jax.jit
def psum_step(x):
    return jax.shard_map(lambda v: jax.lax.psum(v, "rays"), mesh=mesh,
                         in_specs=P("rays"), out_specs=P())(x)

x = jnp.arange(4, dtype=jnp.float32)
out = psum_step(jax.device_put(
    x, jax.sharding.NamedSharding(mesh, P("rays"))))
np.testing.assert_allclose(np.asarray(out), 6.0)
print(f"proc {pid} OK")
"""


_RENDER_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental import multihost_utils

from fspt_tpu.config import RenderConfig
from fspt_tpu.parallel import multihost
from fspt_tpu.parallel.dist import make_sharded_sample_step
from fspt_tpu.runtime.renderer import CameraState, Renderer
from fspt_tpu.testing import make_test_scene

port, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=2, process_id=pid)
mesh = multihost.global_mesh()
assert mesh.devices.size == 4

# production estimator machinery at test scale: compact schedule +
# state-order coherence sort + deferred radiance deposits (the wavefront
# batch is a Renderer-path feature; dist.py loops batch_spp per shard)
scene = make_test_scene()
cfg = RenderConfig(width=32, height=32, bounces=2,
                   extra_refraction_iters=1, batch_spp=1, seed=0,
                   compact=True, sort_state=True)
arrays = scene.device_arrays()
cam = CameraState.from_config(scene.camera)
n = cfg.width * cfg.height
step = make_sharded_sample_step(mesh, cfg, scene.meta)
accum = jax.device_put(np.zeros((3, n), np.float32),
                       NamedSharding(mesh, P(None, "rays")))
count = jnp.zeros(())
key = jax.random.key(cfg.seed)
for i in range(2):
    accum, count, shard_rays = step(arrays, cam, accum, count, key, i)
assert float(np.asarray(multihost_utils.process_allgather(
    shard_rays, tiled=True)).min()) > 0
sharded = np.asarray(
    multihost_utils.process_allgather(accum, tiled=True)) / float(count)

# single-device reference, computed locally in this same process
r = Renderer(scene, cfg)
r.step(2)
single = np.asarray(r.accum) / 2.0

img_sharded = np.zeros((n, 3), np.float32)
img_sharded[step.pixel_order] = sharded.T
img_single = np.zeros((n, 3), np.float32)
img_single[np.asarray(r.pixel_idx)] = single.T
np.testing.assert_array_equal(img_sharded, img_single)
print(f"proc {pid} RENDER OK")
"""


def _run_two_procs(worker, timeout):
    port = socket.socket()
    port.bind(("127.0.0.1", 0))
    portno = port.getsockname()[1]
    port.close()
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(__file__))]
                   + sys.path))
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(portno), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode())
    return procs, outs


def test_two_process_cpu_smoke(tmp_path):
    if os.environ.get("FSPT_TEST_ON_DEVICE"):
        pytest.skip("multi-process smoke is a CPU-backend test")
    procs, outs = _run_two_procs(_WORKER, 300)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out


def test_two_process_render_per_pixel_exact(tmp_path):
    """Cross-PROCESS per-pixel exactness (round-4 VERDICT weak #4: the
    multihost test was a psum smoke, not an estimator check).  The
    2-process / 4-device job renders with the production estimator
    machinery enabled (compact schedule, sort_state coherence sort,
    deferred deposits) and the allgathered image must equal the
    single-device renderer bit-for-bit — the same lane-id-keyed-RNG
    argument as tests/test_parallel.py, now across process boundaries."""
    if os.environ.get("FSPT_TEST_ON_DEVICE"):
        pytest.skip("multi-process exactness is a CPU-backend test")
    procs, outs = _run_two_procs(_RENDER_WORKER, 600)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} RENDER OK" in out
