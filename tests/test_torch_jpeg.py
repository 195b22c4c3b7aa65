"""The port's JPEG codec (csrc/jpeg.cc, data/jpeg.py) against PIL on
libjpeg-turbo, which is what the JAX package decodes with.

* Decode: PIL-encoded JPEGs at 500x375, 333x211 and 17x9; 4:4:4, 4:2:2 and
  4:2:0; quality 50, 75 and 95; optimised Huffman tables, restart markers,
  grayscale and Adobe CMYK. Every pixel within 1 level of
  ``Image.open(...).convert("RGB")``; the share of bitwise-equal pixels is
  printed (the codec follows libjpeg's integer IDCT, fancy upsampling and
  colour conversion, and the share is 1.0 here).
* Reduced decode: 1/2, 1/4 and 1/8 against PIL after ``draft``, at the same
  tolerance, and the scale rule is Pillow's.
* The encoder: PIL decodes what it writes, and the port's decode of those
  bytes is within 1 level of PIL's.
* Determinism: the SHA-256 of the decode of one fixed port-encoded textured
  image is pinned (chip_smoke.py pins the same constant on the card's host).
* Refusals: a progressive file that libjpeg would block-smooth (its scan
  script stops before the last refinement), arithmetic-coded, lossless,
  12-bit, truncated and non-JPEG data raise ValueError. Complete progressive
  files decode (tests/test_torch_jpeg_progressive.py).
"""

import hashlib
import io

import numpy as np
import pytest
from PIL import Image

from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator

SIZES = [(500, 375), (333, 211), (17, 9)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
# The decode of jpeg.encode(textured_image(RandomState(0)), quality=90).
PINNED_DECODE_SHA256 = (
    "30d6f913c0d32b98ccf6f763fe104d1606a07d092067fc6139f89eea04097b50")


def _image(width, height, seed=0):
  return tfrecord_image_generator.textured_image(
      np.random.RandomState(seed), height, width)


def _pil_jpeg(array, **kw):
  buf = io.BytesIO()
  Image.fromarray(array).save(buf, "JPEG", **kw)
  return buf.getvalue()


def _check(data, scale=1, need=None):
  im = Image.open(io.BytesIO(data))
  if need is not None:
    im.draft("RGB", need)
  ref = np.asarray(im.convert("RGB"))
  got = jpeg.decode(data, scale)
  assert got.shape == ref.shape and got.dtype == np.uint8
  diff = np.abs(got.astype(np.int32) - ref)
  print(f"bitwise-equal share {np.mean(diff == 0):.6f}, max |diff| "
        f"{diff.max()}")
  assert diff.max() <= 1


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_decode_matches_pil(size, subsampling, quality):
  data = _pil_jpeg(_image(*size), quality=quality,
                   subsampling=SUBSAMPLING[subsampling])
  assert jpeg.info(data) == (size[0], size[1], 3)
  _check(data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", ["optimize", "restart", "grayscale",
                                     "cmyk"])
def test_decode_variants_match_pil(size, variant):
  img = _image(*size, seed=1)
  if variant == "optimize":
    data = _pil_jpeg(img, optimize=True, quality=85)
  elif variant == "restart":
    data = _pil_jpeg(img, restart_marker_blocks=3)
  elif variant == "grayscale":
    data = _pil_jpeg(img[..., 1])
  else:
    buf = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(buf, "JPEG", quality=90)
    data = buf.getvalue()
  _check(data)


@pytest.mark.parametrize("size", SIZES[:2], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("scale", [2, 4, 8])
def test_reduced_decode_matches_pil_draft(size, subsampling, scale):
  data = _pil_jpeg(_image(*size, seed=2), quality=90,
                   subsampling=SUBSAMPLING[subsampling])
  # A request just under 1/scale of the frame: Pillow's rule picks scale.
  need = (size[0] // scale, size[1] // scale)
  assert jpeg.draft_scale(size, need) == scale
  _check(data, scale, need)


def test_reduced_decode_of_grayscale_and_a_tiny_image():
  _check(_pil_jpeg(_image(333, 211)[..., 0]), 4, (333 // 4, 211 // 4))
  tiny = _pil_jpeg(_image(17, 9), subsampling=2)
  _check(tiny, 8, (2, 1))


def test_draft_scale_is_pillows_rule():
  for size, need in [((500, 375), (224, 224)), ((500, 375), (60, 40)),
                     ((500, 375), (62, 46)), ((64, 64), (64, 64)),
                     ((512, 384), (64, 64)), ((9, 9), (1, 1))]:
    im = Image.open(io.BytesIO(_pil_jpeg(_image(*size))))
    im.draft("RGB", need)
    s = jpeg.draft_scale(size, need)
    assert im.size == (-(-size[0] // s), -(-size[1] // s))


@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [30, 90])
def test_port_encoder_output_decodes_in_pil_and_in_the_port(subsampling,
                                                            quality):
  img = _image(500, 375, seed=4)
  data = jpeg.encode(img, quality=quality, subsampling=subsampling)
  ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
  assert ref.shape == img.shape
  # A lossy copy of the image, not noise.
  assert np.abs(ref.astype(np.int32) - img).mean() < 20
  _check(data)


def test_port_encoder_grayscale_and_odd_sizes():
  for h, w in [(9, 17), (1, 1), (31, 8)]:
    img = _image(w, h, seed=5)
    _check(jpeg.encode(img, quality=75))
    _check(jpeg.encode(img[..., 0], quality=75))


def test_pinned_decode_digest():
  data = jpeg.encode(tfrecord_image_generator.textured_image(
      np.random.RandomState(0)), quality=90)
  assert hashlib.sha256(jpeg.decode(data).tobytes()).hexdigest() == \
      PINNED_DECODE_SHA256


def _with_sof(data, marker, precision=None):
  i = data.index(b"\xff\xc0")
  out = bytearray(data)
  out[i + 1] = marker
  if precision is not None:
    out[i + 4] = precision
  return bytes(out)


def _without_last_scan(data):
  """A progressive file without its last scan (the final luma AC
  refinement): libjpeg decodes it with block smoothing."""
  last = data.rindex(b"\xff\xda")
  return data[:last] + b"\xff\xd9"


@pytest.mark.parametrize("kind,match", [
    ("progressive", r"progressive JPEG \(SOF2\)"),
    ("arithmetic", r"arithmetic-coded JPEG \(SOF9\)"),
    ("lossless", r"lossless JPEG \(SOF3\)"),
    ("12-bit", r"12-bit JPEG \(SOF1\)"),
    ("truncated-scan", "truncated JPEG"),
    ("truncated-header", "truncated JPEG"),
    ("not-a-jpeg", "not a JPEG")])
def test_refusals_raise_value_error(kind, match):
  img = _image(96, 64, seed=6)
  base = _pil_jpeg(img)
  data = {
      "progressive": lambda: _without_last_scan(
          _pil_jpeg(img, progressive=True)),
      "arithmetic": lambda: _with_sof(base, 0xC9),
      "lossless": lambda: _with_sof(base, 0xC3),
      "12-bit": lambda: _with_sof(base, 0xC1, precision=12),
      "truncated-scan": lambda: base[:len(base) // 2],
      "truncated-header": lambda: base[:200],
      "not-a-jpeg": lambda: b"\x89PNG\r\n\x1a\n" + base,
  }[kind]()
  with pytest.raises(ValueError, match=match):
    jpeg.decode(data)


def test_every_truncation_point_raises_and_never_crashes():
  base = _pil_jpeg(_image(40, 24, seed=7))
  for cut in range(0, len(base) - 2, 7):
    with pytest.raises(ValueError):
      jpeg.decode(base[:cut])
