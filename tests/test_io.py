"""Image I/O tests: PNG/HDR round trips and reference naming conventions."""
import numpy as np

from pathtracer_tpu.io.image import (load_png, reference_style_name, save_hdr,
                                     save_png, to_uint8)


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((16, 24, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    save_png(img, p, mirror_x=False)
    back = load_png(p)
    assert back.shape == img.shape
    np.testing.assert_allclose(back, np.clip(img, 0, 1), atol=1 / 255 + 1e-6)


def test_png_mirror_x(tmp_path):
    """saveImage mirrors x (reference main.cpp:407)."""
    img = np.zeros((2, 4, 3), np.float32)
    img[:, 0, 0] = 1.0  # red in column 0
    p = str(tmp_path / "m.png")
    save_png(img, p, mirror_x=True)
    back = load_png(p)
    assert back[0, -1, 0] > 0.9 and back[0, 0, 0] < 0.1


def test_hdr_writer_valid_radiance(tmp_path):
    """Minimal Radiance RGBE output: header + decodable pixel values."""
    img = np.array([[[0.5, 1.0, 2.0], [0.0, 0.0, 0.0]]], np.float32)
    p = str(tmp_path / "x.hdr")
    save_hdr(img, p, mirror_x=False)
    raw = open(p, "rb").read()
    assert raw.startswith(b"#?RADIANCE")
    header_end = raw.index(b"\n-Y")
    dims = raw[header_end + 1:].split(b"\n", 1)[0]
    assert dims == b"-Y 1 +X 2"
    rgbe = np.frombuffer(raw.split(b"-Y 1 +X 2\n", 1)[1], np.uint8)
    rgbe = rgbe.reshape(1, 2, 4)
    # decode pixel 0: value = mantissa/256 * 2^(e-128)
    e = rgbe[0, 0, 3].astype(np.int32) - 128
    decoded = rgbe[0, 0, :3].astype(np.float64) / 256.0 * 2.0 ** e
    np.testing.assert_allclose(decoded, [0.5, 1.0, 2.0], rtol=0.02)
    # zero pixel encodes to all-zero
    assert (rgbe[0, 1] == 0).all()


def test_to_uint8_clamps():
    img = np.array([[[-1.0, 0.5, 7.0]]], np.float32)
    out = to_uint8(img)
    assert out.tolist() == [[[0, 127, 255]]]


def test_reference_style_name():
    name = reference_style_name("cornell", 500)
    assert name.startswith("cornell.") and name.endswith(".500samp.png")


def _filtered_png(arr, filters):
    """PNG bytes of [H,W,3] uint8 with the given filter type on each row
    (forward filters of the PNG spec), to exercise every decoder path."""
    import struct
    import zlib

    from pathtracer_tpu.io.image import _chunk

    h, w, _ = arr.shape
    bpp = 3
    rows = arr.reshape(h, w * 3).astype(np.int64)
    out = []
    prior = np.zeros(w * 3, np.int64)
    for y, f in enumerate(filters):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = (np.abs(p - left), np.abs(p - prior),
                          np.abs(p - upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
        prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(out)))
            + _chunk(b"IEND", b""))


def test_png_decoder_every_filter():
    """All five PNG row filters (None, Sub, Up, Average, Paeth) decode."""
    from pathtracer_tpu.io.image import decode_png

    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (10, 7, 3), dtype=np.uint8)
    data = _filtered_png(arr, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(decode_png(data), arr)


def test_png_encode_decode_bytes_roundtrip():
    from pathtracer_tpu.io.image import decode_png, encode_png

    rng = np.random.default_rng(6)
    arr = rng.integers(0, 256, (33, 17, 3), dtype=np.uint8)
    data = encode_png(arr)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(data), arr)


def test_golden_png_decodes():
    """The reference's golden render (8-bit RGB, filtered rows) decodes to a
    plausible Cornell image: lit, red wall on one side, green on the other."""
    from pathtracer_tpu.scene.fixtures import golden_path

    img = load_png(golden_path())
    assert img.shape == (800, 800, 3) and img.dtype == np.float32
    assert 0.05 < img.mean() < 0.9
    left, right = img[300:500, 20:120].mean((0, 1)), img[300:500, -120:-20].mean((0, 1))
    # one side wall is red-dominant, the other green-dominant
    walls = {tuple(np.argsort(left)[-1:]), tuple(np.argsort(right)[-1:])}
    assert walls == {(0,), (1,)}, (left, right)


def test_png_rejects_unsupported():
    import struct
    import zlib

    import pytest

    from pathtracer_tpu.io.image import _chunk, decode_png

    ihdr = struct.pack(">IIBBBBB", 1, 1, 16, 2, 0, 0, 0)   # 16-bit
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"\x00" + b"\x00" * 6))
            + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(data)
