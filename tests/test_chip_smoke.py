"""chip_smoke.py refuses a CPU backend, and its phases run end to end at
toy size on the CPU (kernel in interpret mode); stdlib PNG writer."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def toy_scene():
    from fspt_tpu.testing import make_bunny_standin_scene
    return make_bunny_standin_scene(subdivisions=2)


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out and "needs a GPU" in out


@pytest.mark.parametrize("phase", ["kernel", "timing", "render", "gradient",
                                   "refit", "multi"])
def test_chip_smoke_phase_at_toy_size(toy_scene, phase):
    cs = chip_smoke
    calls = {
        "kernel": lambda: cs.phase_kernel(toy_scene, 64, interpret=True),
        "timing": lambda: cs.kernel_timing(toy_scene, size=32,
                                           interpret=True, reps=1),
        "render": lambda: cs.phase_render(toy_scene, size=32, spp=2,
                                          steps=1, expect_kernel=False),
        "gradient": lambda: cs.phase_gradient(toy_scene, size=16),
        "refit": lambda: cs.phase_refit(1),
        "multi": lambda: cs.phase_multi(toy_scene, size=16, n_dev=4, spp=2,
                                        train_size=16),
    }
    lines = calls[phase]()
    assert lines and all(isinstance(x, str) for x in lines)


def test_png_writer_round_trip(tmp_path):
    from fspt_tpu.io.image import write_png
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, pos = {}, 8
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        crc = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])[0]
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + size
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, color) == (7, 5, 8, 2)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)
    from fspt_tpu.io.image import read_png
    np.testing.assert_allclose(read_png(str(path)) * 255.0, img, atol=0.5)


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    import jax
    from fspt_tpu import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_inside_the_checkout(monkeypatch):
    import jax
    from fspt_tpu import compile_cache
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.use_compile_cache()
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
