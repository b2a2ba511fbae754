"""Command-line interface: `python -m fspt_tpu <command>`.

The reference's "CLI" is its URL query grammar
(reference main.js:953-975: `scene=`, `res=WxH|S|Nx`, `frame=N`,
`mode=test|nee|alpha`) plus DOM sliders; this maps the same controls onto
argparse subcommands:

  render   one still image (mode=render / mode=test via --mode)
  animate  frame-sequence batch driver (the reference's frame=N loop)
  diff     compare two renders (the reference's tools/ page)
  info     scene statistics (tri/BVH/atlas/env summary)
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p):
    p.add_argument("scene", help="scene JSON path")
    p.add_argument("--res", default="512",
                   help="WxH | S (square) | Nx (window multiple; window=1280x720)")
    p.add_argument("--samples", type=int, default=None,
                   help="override scene sample cap")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--batch-spp", type=int, default=4)
    p.add_argument("--mode", choices=["render", "bvh_heatmap"],
                   default="render")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--denoise", action="store_true",
                   help="firefly sigma-clamp filter")
    p.add_argument("--exposure", type=float, default=None)
    p.add_argument("--autofocus", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path for resume")
    p.add_argument("--stats", action="store_true",
                   help="print rays/s stats JSON to stderr")
    p.add_argument("--no-compact", action="store_true",
                   help="disable active-lane compaction between bounces "
                        "(exact-replay/debug mode; compaction is unbiased "
                        "and on by default for rendering)")


def _build(args):
    from fspt_tpu.config import PostConfig, RenderConfig, resolution_from_spec
    from fspt_tpu.runtime.renderer import Renderer
    from fspt_tpu.scene.schema import load_scene_file

    w, h = resolution_from_spec(args.res)
    scene = load_scene_file(args.scene)
    cfg = RenderConfig(width=w, height=h, bounces=args.bounces,
                       batch_spp=args.batch_spp, mode=args.mode,
                       seed=args.seed, compact=not args.no_compact,
                       sort_state=not args.no_compact,
                       nee_env_nearest=not args.no_compact,
                       escape_env_nearest=not args.no_compact)
    post = None
    if args.denoise or args.exposure is not None:
        post = PostConfig(
            exposure=(args.exposure if args.exposure is not None
                      else scene.post.exposure),
            denoise=args.denoise)
    return scene, Renderer(scene, cfg, post=post)


def cmd_render(args) -> int:
    import os
    scene, r = _build(args)
    if args.autofocus:
        t = r.autofocus()
        print(f"autofocus: focal depth {t:.4f}", file=sys.stderr)
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)
    target = args.samples if args.samples is not None else scene.samples
    t0 = time.time()
    while float(r.count) < target:
        remaining = -(-int(target - float(r.count)) // r.cfg.batch_spp)
        r.step(min(8, max(1, remaining)))
        if args.checkpoint:
            r.save_checkpoint(args.checkpoint)
        done = float(r.count)
        rate = done / max(time.time() - t0, 1e-9)
        print(f"\r{int(done)}/{target} spp ({rate:.1f} spp/s)",
              end="", file=sys.stderr)
    print("", file=sys.stderr)
    r.save(args.out)
    if args.stats:
        print(json.dumps(r.stats), file=sys.stderr)
    print(args.out)
    return 0


def cmd_animate(args) -> int:
    import os
    from fspt_tpu.config import RenderConfig, resolution_from_spec
    from fspt_tpu.runtime.animation import render_animation
    from fspt_tpu.scene.schema import AssetLoader

    w, h = resolution_from_spec(args.res)
    with open(args.scene) as f:
        scene_dict = json.load(f)
    loader = AssetLoader(os.path.dirname(os.path.abspath(args.scene)))
    cfg = RenderConfig(width=w, height=h, bounces=args.bounces,
                       batch_spp=args.batch_spp, seed=args.seed,
                       compact=not args.no_compact,
                       sort_state=not args.no_compact,
                       nee_env_nearest=not args.no_compact,
                       escape_env_nearest=not args.no_compact)
    paths = render_animation(
        scene_dict, loader, args.out_dir,
        range(args.start, args.end), config=cfg, samples=args.samples,
        name=os.path.splitext(os.path.basename(args.scene))[0],
        refit=args.refit)
    print("\n".join(paths))
    return 0


def cmd_view(args) -> int:
    """Interactive fly-through viewer (reference main.js:619-739,838-857)."""
    scene, r = _build(args)
    from fspt_tpu.runtime.viewer import InteractiveViewer
    v = InteractiveViewer(scene, r.cfg, post=r.post)
    if args.autofocus:
        v.renderer.autofocus()
        v.preview.camera = v.renderer.camera
    v.serve(port=args.port, host=args.host)
    return 0


def cmd_info(args) -> int:
    from fspt_tpu.scene.schema import load_scene_file
    scene = load_scene_file(args.scene)
    a = scene.arrays
    print(json.dumps({
        "name": scene.name,
        "triangles": scene.num_triangles,
        "slots": int(a.ior.shape[0]),
        "bvh_depth": scene.bvh_depth,
        "bvh_nodes": int(a.node_left.shape[0]),
        "leaf_size": scene.leaf_size,
        "packed_tables_mb": round((a.pk_nodes.nbytes + a.pk_leaves.nbytes)
                                  / 1e6, 2),
        "atlas_layers": scene.meta.atlas_layers,
        "atlas_res": scene.meta.atlas_res,
        "env": [scene.meta.env_h, scene.meta.env_w],
        "env_bins": int(a.n_bins),
        "light_tris": int(a.n_light_tris),
        "samples": scene.samples,
    }, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fspt_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render one image")
    _add_render_args(pr)
    pr.add_argument("-o", "--out", default="out.png")
    pr.set_defaults(fn=cmd_render)

    pa = sub.add_parser("animate", help="render a frame sequence")
    _add_render_args(pa)
    pa.add_argument("--start", type=int, default=0)
    pa.add_argument("--end", type=int, required=True)
    pa.add_argument("-o", "--out-dir", default="frames")
    pa.add_argument("--refit", action="store_true",
                    help="transform-only frames: skip the per-frame host "
                         "scene rebuild and refit the BVH on-device "
                         "(scene/refit.py; falls back to rebuild when the "
                         "scene uses `normalize`)")
    pa.set_defaults(fn=cmd_animate)

    pv = sub.add_parser("view", help="interactive fly-through viewer")
    _add_render_args(pv)
    pv.add_argument("--port", type=int, default=8787)
    pv.add_argument("--host", default="127.0.0.1")
    pv.set_defaults(fn=cmd_view)

    pd = sub.add_parser("diff", help="compare two renders")
    pd.set_defaults(fn=None)

    pi = sub.add_parser("info", help="scene statistics")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "diff":
        from fspt_tpu.tools.diff import main as diff_main
        return diff_main(argv[1:])
    args = p.parse_args(argv)
    from fspt_tpu.compile_cache import use_compile_cache
    use_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
