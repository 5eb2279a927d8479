"""The standard-library PNG writer and the compile-cache helper."""

import struct
import zlib

import numpy as np
import pytest

from computational_ray_tracer_tpu.utils import compile_cache, image


def _decode_png(data):
    """Minimal decoder for the writer's output: 8-bit gray or RGB,
    filter type 0 on every row."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert depth == 8 and b"IEND" in chunks
    ch = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape((h, w, ch) if ch == 3 else (h, w))


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgb", "gray"])
def test_png_round_trip(tmp_path, kind):
    rng = np.random.default_rng(0)
    if kind == "float_rgb":
        img = rng.uniform(-0.2, 1.2, (7, 5, 3)).astype(np.float32)
        want = image.to_uint8(img)
    elif kind == "uint8_rgb":
        img = want = rng.integers(0, 256, (4, 9, 3)).astype(np.uint8)
    else:
        img = rng.uniform(0.0, 1.0, (6, 6)).astype(np.float32)
        want = image.to_uint8(img)
    path = tmp_path / "img.png"
    image.write_png(str(path), img)
    np.testing.assert_array_equal(_decode_png(path.read_bytes()), want)


def test_png_rejects_bad_shape():
    with pytest.raises(ValueError):
        image.png_bytes(np.zeros((2, 2, 4), np.uint8))


class _Config:
    def __init__(self):
        self.calls = {}

    def update(self, name, value):
        self.calls[name] = value


@pytest.mark.parametrize("env_dir", [None, "/somewhere/cache"])
def test_compile_cache_paths(monkeypatch, env_dir, tmp_path):
    import jax
    cfg = _Config()
    monkeypatch.setattr(jax, "config", cfg)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", str(tmp_path / "xla"))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable() == str(tmp_path / "xla")
        assert cfg.calls["jax_compilation_cache_dir"] == str(tmp_path / "xla")
        assert (tmp_path / "xla").is_dir()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.enable() == env_dir
        # JAX reads the variable itself; no other path is set
        assert "jax_compilation_cache_dir" not in cfg.calls


def test_compile_cache_default_is_fixed_checkout_path():
    import os
    assert compile_cache.DEFAULT_DIR == os.path.join(
        compile_cache.CHECKOUT, ".cache", "xla")
    assert os.path.isdir(os.path.join(compile_cache.CHECKOUT,
                                      "computational_ray_tracer_tpu"))
