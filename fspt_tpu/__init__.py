"""fspt_tpu — a differentiable, progressive Monte-Carlo path-tracing
framework built from scratch in JAX (jit / shard_map / Pallas), run on the
GPU.

Capability parity target: apbodnar/FSPT (a WebGL2 fragment-shader path tracer).
The reference's GLSL megakernel (reference shader/tracer.fs) becomes a jitted,
vectorized wavefront integrator over SoA ray batches; its JS scene compiler
(main.js initBVH) becomes a NumPy/C++ host pipeline producing a pytree of
device arrays; its texture ping-pong accumulation becomes a lax.scan over
sample batches; distribution (absent in the reference) is first-class via
jax.sharding meshes.

Public API:
    fspt_tpu.load_scene(path_or_dict)     -> Scene (host) + SceneArrays (device)
    fspt_tpu.Renderer(scene, config)      -> progressive renderer
    fspt_tpu.render(scene, config)        -> one-shot render to HDR image
"""

__version__ = "0.1.0"

from fspt_tpu.config import RenderConfig, PostConfig, CameraConfig
from fspt_tpu.scene.schema import load_scene_file, load_scene_dict, Scene
from fspt_tpu.runtime.animation import render_animation
from fspt_tpu.runtime.renderer import Renderer, render

__all__ = [
    "RenderConfig",
    "PostConfig",
    "CameraConfig",
    "load_scene_file",
    "load_scene_dict",
    "Scene",
    "Renderer",
    "render",
    "render_animation",
]
