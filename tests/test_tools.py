"""Tools layer: image diff, animation driver, CLI plumbing."""

import json
import os

import numpy as np
import pytest

from fspt_tpu.runtime.animation import (interpolate_keyframes,
                                        render_animation, scene_for_frame)
from fspt_tpu.tools.diff import compare, diff_image


def test_diff_identical_images():
    img = np.random.default_rng(0).uniform(0, 1, (8, 8, 3))
    res = compare(img, img)
    assert res.mse == 0.0
    assert res.frac_above == 0.0
    assert res.psnr_db == float("inf")


def test_diff_metrics_known_offset():
    a = np.zeros((4, 4, 3))
    b = np.full((4, 4, 3), 0.1)
    res = compare(a, b)
    np.testing.assert_allclose(res.rmse, 0.1, rtol=1e-9)
    np.testing.assert_allclose(res.max_abs, 0.1, rtol=1e-9)
    assert res.frac_above == 1.0
    d = diff_image(a, b, mode="abs", gain=5.0)
    np.testing.assert_allclose(d, 0.5, rtol=1e-6)


def test_diff_expr():
    """User-editable comparison expression (reference tools/image_tool.js
    editable shader parity): arbitrary NumPy expressions over a and b,
    grayscale broadcast, shape validation."""
    from fspt_tpu.tools.diff import expr_image
    a = np.full((4, 4, 3), 0.5, np.float32)
    b = np.full((4, 4, 3), 0.2, np.float32)
    np.testing.assert_allclose(expr_image(a, b, "abs(a - b)"), 0.3,
                               rtol=1e-6)
    # the reference's default shader: tex1.r -> R, tex2.r -> G
    rg = expr_image(a, b, "np.stack([a[...,0], b[...,0], 0*a[...,0]], -1)")
    np.testing.assert_allclose(rg[..., 0], 0.5, rtol=1e-6)
    np.testing.assert_allclose(rg[..., 1], 0.2, rtol=1e-6)
    # scalar field -> grayscale
    g = expr_image(a, b, "(a - b).sum(-1)", gain=0.5)
    assert g.shape == (4, 4, 3)
    np.testing.assert_allclose(g, 0.45, rtol=1e-6)
    with pytest.raises(ValueError):
        expr_image(a, b, "a[0]")


def test_diff_cli_expr(tmp_path):
    from fspt_tpu.io.image import read_png, write_png
    from fspt_tpu.tools.diff import main
    a = tmp_path / "a.png"
    b = tmp_path / "b.png"
    out = tmp_path / "d.png"
    write_png(str(a), np.full((8, 8, 3), 0.75))
    write_png(str(b), np.full((8, 8, 3), 0.25))
    rc = main([str(a), str(b), "-o", str(out), "--expr", "a - b",
               "--gain", "1.0"])
    assert rc == 0
    np.testing.assert_allclose(read_png(str(out)), 0.5, atol=2 / 255)


def test_diff_cli(tmp_path):
    from fspt_tpu.io.image import write_png
    from fspt_tpu.tools.diff import main
    a = tmp_path / "a.png"
    b = tmp_path / "b.png"
    out = tmp_path / "d.png"
    write_png(str(a), np.zeros((8, 8, 3)))
    write_png(str(b), np.full((8, 8, 3), 0.5))
    rc = main([str(a), str(b), "-o", str(out), "--max-rmse", "0.1"])
    assert rc == 1          # rmse 0.5 > 0.1
    assert out.exists()
    rc = main([str(a), str(a), "--max-rmse", "0.1"])
    assert rc == 0


def test_keyframe_interpolation():
    prop = {"path": "x.obj",
            "keyframes": [
                {"frame": 0, "translate": [0, 0, 0], "scale": 1.0,
                 "rotate": [{"axis": [0, 1, 0], "angle": 0.0}]},
                {"frame": 10, "translate": [10, 0, 0], "scale": 3.0,
                 "rotate": [{"axis": [0, 1, 0], "angle": 1.0}]},
            ]}
    mid = interpolate_keyframes(prop, 5)
    np.testing.assert_allclose(mid["translate"], [5, 0, 0])
    np.testing.assert_allclose(mid["scale"], 2.0)
    np.testing.assert_allclose(mid["rotate"][0]["angle"], 0.5)
    # clamped outside range
    assert interpolate_keyframes(prop, 99)["translate"] == [10, 0, 0]
    # props without keyframes pass through
    assert interpolate_keyframes({"path": "y.obj"}, 3) == {"path": "y.obj"}


def test_scene_for_frame_merges_animated():
    scene = {"props": [{"path": "a.obj"}],
             "animated_props": {
                 "spin": {"path": "b.obj",
                          "keyframes": [{"frame": 0, "scale": 1.0},
                                        {"frame": 2, "scale": 2.0}]}}}
    out = scene_for_frame(scene, 1)
    assert out["animated_props"]["spin"]["scale"] == 1.5
    assert "keyframes" not in out["animated_props"]["spin"]


def test_render_animation_resumable(tmp_path):
    from fspt_tpu.config import RenderConfig
    from fspt_tpu.testing import DictAssetLoader, icosphere_obj, quad_obj

    loader = DictAssetLoader(texts={"s.obj": icosphere_obj(0),
                                    "f.obj": quad_obj()})
    scene_dict = {
        "environment": [[0.5, 0.5, 0.6], [0.1, 0.1, 0.1]],
        "cameraPos": [0, 0.4, 2.2], "cameraDir": [0, -0.18, -0.98],
        "props": [{"path": "f.obj", "scale": 6,
                   "translate": [0, -0.5, 0], "diffuse": [0.6, 0.6, 0.6]}],
        "animated_props": {
            "ball": {"path": "s.obj", "scale": 0.5,
                     "diffuse": [0.9, 0.4, 0.3],
                     "keyframes": [{"frame": 0, "translate": [-1, 0, 0]},
                                   {"frame": 3, "translate": [1, 0, 0]}]}},
    }
    cfg = RenderConfig(width=16, height=16, bounces=1,
                       extra_refraction_iters=0, batch_spp=2)
    out = str(tmp_path / "frames")
    paths = render_animation(scene_dict, loader, out, range(0, 2),
                             config=cfg, samples=2)
    assert all(os.path.exists(p) for p in paths)
    # resume: second call skips everything (mtimes unchanged)
    mtimes = [os.path.getmtime(p) for p in paths]
    paths2 = render_animation(scene_dict, loader, out, range(0, 2),
                              config=cfg, samples=2)
    assert [os.path.getmtime(p) for p in paths2] == mtimes
    # frames differ (the ball moved)
    from fspt_tpu.io.image import read_png
    assert not np.array_equal(read_png(paths[0]), read_png(paths[1]))


def test_cli_production_config(tmp_path):
    """The CLI render path must build the production estimator config
    (BVH traversal + nearest-env fusion + compaction + state sort), and
    --no-compact must fall back to the exact-parity debug config — a
    regression tripwire so the shipped CLI never silently loses the perf
    levers."""
    from argparse import Namespace
    from fspt_tpu.testing import icosphere_obj
    scene_path = tmp_path / "s.json"
    (tmp_path / "mesh.obj").write_text(icosphere_obj(0))
    scene_path.write_text(json.dumps({
        "environment": [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]],
        "props": [{"path": "mesh.obj", "diffuse": [1, 0, 0]}],
    }))
    from fspt_tpu.__main__ import _build
    args = Namespace(scene=str(scene_path), res="32", bounces=2,
                     batch_spp=1, mode="render", seed=0, denoise=False,
                     exposure=None, no_compact=False)
    _, r = _build(args)
    assert r.cfg.intersector == "bvh"
    assert r.cfg.compact and r.cfg.sort_state
    assert r.cfg.nee_env_nearest and r.cfg.escape_env_nearest
    args.no_compact = True
    _, r = _build(args)
    assert r.cfg.intersector == "bvh"
    assert not (r.cfg.compact or r.cfg.sort_state
                or r.cfg.nee_env_nearest or r.cfg.escape_env_nearest)


def test_cli_info(tmp_path, capsys):
    # build a tiny scene file on disk with relative assets
    from fspt_tpu.testing import icosphere_obj
    scene_path = tmp_path / "s.json"
    (tmp_path / "mesh.obj").write_text(icosphere_obj(0))
    scene_path.write_text(json.dumps({
        "environment": [[0.2, 0.2, 0.2], [0.8, 0.8, 0.8]],
        "props": [{"path": "mesh.obj", "diffuse": [1, 0, 0]}],
    }))
    from fspt_tpu.__main__ import main
    rc = main(["info", str(scene_path)])
    assert rc == 0
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] == 20
    assert info["bvh_depth"] >= 1
