"""PyTorch port, PNG IO (``data/png.py``) against ``cv2.imread``, the JAX
package's decoder: the numpy decoder gives OpenCV's pixels bit for bit in
``IMREAD_COLOR`` (as RGB), ``IMREAD_GRAYSCALE`` and ``IMREAD_UNCHANGED``,
on files OpenCV wrote (its own choice of row filters) and on files with
every row in one of the five filter types; the writer round-trips."""

import zlib

import cv2
import numpy as np
import pytest

from practicaldeepstereo_nips2018_tpu_torch.data import png

FLAGS = {"color": cv2.IMREAD_COLOR, "grayscale": cv2.IMREAD_GRAYSCALE,
         "unchanged": cv2.IMREAD_UNCHANGED}
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}


def _opencv(path: str, mode: str) -> np.ndarray:
    image = cv2.imread(path, FLAGS[mode])
    if image.ndim == 3:  # BGR(A) -> RGB(A)
        image = np.concatenate([image[..., 2::-1], image[..., 3:]], axis=2)
    return image


def _smooth_image(shape, seed: int, dtype=np.uint8) -> np.ndarray:
    """Gradients plus noise: OpenCV's writer picks several filter types
    on such rows."""
    rng = np.random.RandomState(seed)
    top = 65536 if dtype == np.uint16 else 256
    rows, columns = np.indices(shape[:2])
    base = (rows * 7 + columns * 3) * (top // 256)
    if len(shape) == 3:
        base = base[..., None] * np.arange(1, shape[2] + 1)
    return ((base + rng.randint(0, 4 * top // 256, shape)) % top).astype(
        dtype)


CASES = {
    "rgb8": ((23, 37, 3), np.uint8, ("color", "unchanged")),
    "gray8": ((23, 37), np.uint8, ("color", "grayscale", "unchanged")),
    "gray16": ((23, 37), np.uint16, ("color", "grayscale", "unchanged")),
}


def _expect_equal(path: str, modes) -> None:
    for mode in modes:
        expected = _opencv(path, mode)
        for decoder in png.DECODERS:
            got = png.read_png(path, mode, decoder=decoder)
            assert got.dtype == expected.dtype, (mode, decoder)
            np.testing.assert_array_equal(got, expected, err_msg=(
                f"{path} {mode} {decoder}"))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("filter_name", sorted(FILTERS))
def test_numpy_decoder_equals_opencv_on_each_filter(tmp_path, case,
                                                    filter_name):
    shape, dtype, modes = CASES[case]
    top = 65536 if dtype == np.uint16 else 256
    image = np.random.RandomState(1).randint(0, top, shape).astype(dtype)
    path = str(tmp_path / "image.png")
    png.write_png(path, image, filter_type=FILTERS[filter_name])
    _expect_equal(path, modes)
    np.testing.assert_array_equal(
        png.read_png(path, "unchanged", decoder="numpy"), image)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_decoder_equals_opencv_on_opencv_files(tmp_path, case):
    shape, dtype, modes = CASES[case]
    image = _smooth_image(shape, 2, dtype)
    path = str(tmp_path / "image.png")
    cv2.imwrite(path, image[..., ::-1] if image.ndim == 3 else image)
    _expect_equal(path, modes)


def _image_data(content: bytes) -> tuple[bytes, int, int]:
    """(decompressed image data, offset and length of the one IDAT)."""
    start = content.index(b"IDAT") + 4
    length = int.from_bytes(content[start - 8:start - 4], "big")
    return zlib.decompress(content[start:start + length]), start, length


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_decoder_equals_opencv_on_mixed_filters(tmp_path, case):
    """Row r filtered with type r % 5 in one file (rows taken from the five
    single-filter files of the same image): every filter next to every
    other, through the anti-diagonal path."""
    shape, dtype, modes = CASES[case]
    image = _smooth_image(shape, 4, dtype)
    rows = []
    for filter_type in range(5):
        path = str(tmp_path / f"filter{filter_type}.png")
        png.write_png(path, image, filter_type=filter_type)
        with open(path, "rb") as handle:
            content = handle.read()
        data = _image_data(content)[0]
        rows.append(np.frombuffer(data, np.uint8).reshape(shape[0], -1))
    mixed = np.stack([rows[row % 5][row] for row in range(shape[0])])
    assert sorted(set(mixed[:, 0].tolist())) == [0, 1, 2, 3, 4]
    _, start, length = _image_data(content)
    body = zlib.compress(mixed.tobytes())
    chunk = (b"IDAT" + body)
    content = (content[:start - 8] + len(body).to_bytes(4, "big") + chunk
               + zlib.crc32(chunk).to_bytes(4, "big")
               + content[start + length + 4:])
    path = str(tmp_path / "mixed.png")
    with open(path, "wb") as handle:
        handle.write(content)
    _expect_equal(path, modes)


@pytest.mark.parametrize("channels", [2, 4])
def test_alpha_is_dropped_and_gray_replicated(tmp_path, channels):
    """Gray + alpha and RGBA files (OpenCV-written) read as OpenCV reads
    them."""
    image = _smooth_image((11, 13, channels), 3)
    path = str(tmp_path / "image.png")
    if channels == 2:
        image = np.dstack([image[..., :1]] * 3 + [image[..., 1:]])
        cv2.imwrite(path, image)  # BGRA with B=G=R: written as gray+alpha
    else:
        cv2.imwrite(path, image[..., [2, 1, 0, 3]])
    _expect_equal(path, ("color", "unchanged"))


@pytest.mark.parametrize("image", [
    np.arange(6 * 5 * 3, dtype=np.uint8).reshape(6, 5, 3),
    np.arange(30, dtype=np.uint8).reshape(6, 5),
    (np.arange(30, dtype=np.uint16) * 2111).reshape(6, 5)],
    ids=["rgb8", "gray8", "gray16"])
def test_writer_round_trips(tmp_path, image):
    path = str(tmp_path / "image.png")
    for filter_type in FILTERS.values():
        png.write_png(path, image, filter_type=filter_type)
        for decoder in png.DECODERS:
            np.testing.assert_array_equal(
                png.read_png(path, "unchanged", decoder=decoder), image)


def test_default_decoder_and_errors(tmp_path):
    assert png.default_decoder() == "opencv"  # cv2 imports here
    with pytest.raises(ValueError, match="mode"):
        png.read_png(str(tmp_path / "x.png"), "bgr")
    with pytest.raises(ValueError, match="cannot write"):
        png.write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 3)))
    path = str(tmp_path / "rgb.png")
    png.write_png(path, np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="grayscale"):
        png.read_png(path, "grayscale", decoder="numpy")
    content = bytearray(open(path, "rb").read())
    content[20] ^= 1  # inside IHDR
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(content))
