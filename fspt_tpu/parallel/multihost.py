"""Multi-host bring-up: the multi-machine entry the single-browser
reference never needed (SURVEY §5 distributed-communication gap).

Usage on every host of the job:

    from fspt_tpu.parallel import multihost
    multihost.initialize(coordinator_address="host0:port",
                         num_processes=N, process_id=i)
    mesh = multihost.global_mesh()          # 1-D "rays" mesh, all devices
    step = dist.make_sharded_sample_step(mesh, cfg, scene.meta)

Rendering then shards framebuffer tiles over every device in the job; the
scene pytree is replicated; gradient reductions are standard JAX
collectives (NCCL between GPUs), no bespoke transport.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var defaults
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when the
    job is single-process."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("COORDINATOR_ADDRESS"),
        num_processes=num,
        process_id=process_id if process_id is not None else int(
            os.environ.get("PROCESS_ID", "0")))


def global_mesh(axis_name: str = "rays") -> Mesh:
    """1-D mesh over every addressable chip in the job (all hosts)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def is_coordinator() -> bool:
    return jax.process_index() == 0
