"""BMP writer/reader tests (byte layout parity with Renderer.cpp:15-63)."""

import numpy as np

from pathtracerap.io.bmp import quantize_image, read_bmp, write_bmp


def test_bmp_header_and_size(tmp_path):
    img = np.zeros((8, 16, 3), np.uint8)
    p = tmp_path / "t.bmp"
    write_bmp(str(p), img)
    data = p.read_bytes()
    # 54-byte header + 3*w*h body, no row padding (reference quirk)
    assert len(data) == 54 + 3 * 16 * 8
    assert data[:2] == b"BM"
    # file size field at offset 2, data offset 54, 24 bpp at offset 28
    assert int.from_bytes(data[2:6], "little") == len(data)
    assert int.from_bytes(data[10:14], "little") == 54
    assert int.from_bytes(data[28:30], "little") == 24
    assert int.from_bytes(data[18:22], "little") == 16  # width
    assert int.from_bytes(data[22:26], "little") == 8  # height


def test_bmp_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(10, 12, 3), dtype=np.uint8)
    p = tmp_path / "t.bmp"
    write_bmp(str(p), img)
    np.testing.assert_array_equal(read_bmp(str(p)), img)


def test_bmp_standard_mode_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)  # 7*3=21, needs padding
    p = tmp_path / "t.bmp"
    write_bmp(str(p), img, parity=False)
    np.testing.assert_array_equal(read_bmp(str(p), parity=False), img)
    # padded stride
    assert len(p.read_bytes()) == 54 + (21 + 3) * 5


def test_quantize_matches_reference_semantics():
    # color/ITER*255 truncated toward zero (Renderer.cpp:48-50)
    accum = np.array([[[500.0, 250.0, 0.4999]]], np.float32)
    out = quantize_image(accum, 500)
    assert out[0, 0, 0] == 255
    assert out[0, 0, 1] == 127
    assert out[0, 0, 2] == 0
