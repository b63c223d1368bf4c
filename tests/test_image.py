"""Image IO: PPM writer matches the reference saveToPPM format
(utilities.h:842-856); reader round-trips; reference render.ppm loads."""

import numpy as np
import pytest

from gpupathtracer_tpu.render.film import Film, to_u8
from gpupathtracer_tpu.utils.image import read_png, read_ppm, write_png, write_ppm


def test_ppm_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(7, 5, 3), dtype=np.uint8)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    lines = open(p).read().splitlines()
    assert lines[0] == "P3"
    assert lines[1] == "5 7"
    assert lines[2] == "255"
    assert len(lines) == 3 + 7 * 5  # one RGB triple per line, like the reference
    back = read_ppm(p)
    np.testing.assert_array_equal(back, img)


def test_reference_render_ppm_loads():
    img = read_ppm("/root/reference/PathTracer/FireflyEngine/render.ppm")
    assert img.shape == (800, 800, 3)


def test_png_write(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    with open(p, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    assert int.from_bytes(head[16:20], "big") == 4  # width
    assert int.from_bytes(head[20:24], "big") == 4  # height


@pytest.mark.parametrize("shape", [(5, 7, 3), (3, 4, 4), (6, 2), (1, 1, 3)])
def test_png_roundtrip(tmp_path, shape):
    """write_png → read_png returns the pixels unchanged (grey, RGB, RGBA)."""
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    p = str(tmp_path / "rt.png")
    write_png(p, img)
    back = read_png(p)
    want = img if img.ndim == 3 else img[..., None]
    np.testing.assert_array_equal(back, want)


def test_png_reader_rejects_corruption(tmp_path):
    p = str(tmp_path / "bad.png")
    write_png(p, np.zeros((2, 2, 3), np.uint8))
    data = bytearray(open(p, "rb").read())
    data[30] ^= 0xFF  # inside the IHDR/IDAT payload: the CRC no longer matches
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        read_png(p)


def test_to_u8_clamps():
    img = np.asarray([[[2.0, -1.0, 0.5]]], np.float32)
    u8 = to_u8(img)
    np.testing.assert_array_equal(u8, [[[255, 0, 127]]])


def test_film_accumulation():
    import jax.numpy as jnp

    f = Film.zeros(2, 2)
    f = f.add_samples(jnp.ones((2, 2, 3)))
    f = f.add_samples(jnp.zeros((2, 2, 3)))
    np.testing.assert_allclose(np.asarray(f.to_image()), 0.5)
