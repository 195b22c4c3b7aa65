"""The port's progressive JPEG decode (csrc/jpeg.cc, SOF2) against PIL on
libjpeg-turbo, bitwise.

* PIL writes the files with ``progressive=True`` (libjpeg's
  jpeg_simple_progression script: an interleaved DC first scan, AC first
  scans with end-of-band runs, AC and DC refinement scans): 4:4:4, 4:2:2,
  4:2:0 and grayscale, at odd sizes, with and without restart intervals,
  decoded at 1, 1/2, 1/4 and 1/8 scale (Pillow's ``draft``). Every pixel is
  PIL's.
* A file whose scan script stops before the last refinement scan leaves AC
  coefficients incomplete; PIL decodes it with libjpeg's block smoothing,
  which the codec does not do, so the codec refuses it by name.
* A progressive file cut short, one with an illegal spectral selection or
  successive approximation, and an arithmetic-coded progressive file raise
  ValueError naming what is wrong.
"""

import hashlib
import io
import os

import numpy as np
import pytest
from PIL import Image

from kf_benchmarks_tpu_torch.data import jpeg
from kf_benchmarks_tpu_torch.data import tfrecord_image_generator

SIZES = [(97, 61), (17, 9), (333, 211)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "gray": None}


def _image(width, height, seed=0):
  return tfrecord_image_generator.textured_image(
      np.random.RandomState(seed), height, width)


def _progressive(array, **kw):
  buf = io.BytesIO()
  Image.fromarray(array).save(buf, "JPEG", progressive=True, **kw)
  return buf.getvalue()


def _file(size, subsampling, restart, seed=0):
  img = _image(*size, seed=seed)
  kw = {"quality": 80}
  if SUBSAMPLING[subsampling] is None:
    img = img[..., 0]
  else:
    kw["subsampling"] = SUBSAMPLING[subsampling]
  if restart:
    kw["restart_marker_blocks"] = 3
  return _progressive(img, **kw)


def _segments(data):
  """The file as a list of (marker, bytes); a scan's entropy-coded data
  rides with its SOS segment."""
  out = [(0xD8, data[:2])]
  i = 2
  while i < len(data):
    assert data[i] == 0xFF
    m = data[i + 1]
    if m == 0xD9:
      out.append((m, data[i:i + 2]))
      break
    end = i + 2 + (data[i + 2] << 8 | data[i + 3])
    if m == 0xDA:
      while not (data[end] == 0xFF and data[end + 1] != 0 and
                 not 0xD0 <= data[end + 1] <= 0xD7):
        end += 1
    out.append((m, data[i:end]))
    i = end
  return out


def _without_scans(data, drop):
  """``data`` without the scans whose index (0-based, in file order) is in
  ``drop``."""
  kept, scan = [], 0
  for m, seg in _segments(data):
    if m == 0xDA:
      scan += 1
      if scan - 1 in drop:
        continue
    kept.append(seg)
  return b"".join(kept)


def _scan_headers(data):
  """Byte offsets of each scan's (Ss, Se, AhAl) triple."""
  offs, i = [], 0
  for m, seg in _segments(data):
    if m == 0xDA:
      ns = seg[4]
      offs.append(i + 5 + 2 * ns)
    i += len(seg)
  return offs


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
@pytest.mark.parametrize("subsampling", list(SUBSAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_progressive_decode_is_pils(size, subsampling, restart, scale):
  data = _file(size, subsampling, restart)
  assert data[data.index(b"\xff\xc2") + 1] == 0xC2
  w, h = size
  need = (max(1, w // scale), max(1, h // scale))
  s = jpeg.draft_scale(size, need)
  im = Image.open(io.BytesIO(data))
  if s > 1:
    im.draft("RGB", need)
  ref = np.asarray(im.convert("RGB"))
  got = jpeg.decode(data, s)
  assert got.shape == ref.shape and got.dtype == np.uint8
  np.testing.assert_array_equal(got, ref)


def _cmyk(img):
  buf = io.BytesIO()
  Image.fromarray(img).convert("CMYK").save(buf, "JPEG", progressive=True,
                                             quality=85)
  return buf.getvalue()


@pytest.mark.parametrize("kind", ["rgb-500x375", "cmyk"])
def test_progressive_cmyk_and_a_large_image_are_pils(kind):
  img = _image(500, 375, seed=3)
  data = _progressive(img, quality=90) if kind == "rgb-500x375" else \
      _cmyk(img)
  ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
  np.testing.assert_array_equal(jpeg.decode(data), ref)


def test_an_incomplete_scan_script_is_refused_by_name():
  data = _file((97, 61), "4:2:0", False, seed=4)
  n_scans = sum(m == 0xDA for m, _ in _segments(data))
  cut = _without_scans(data, {n_scans - 1})  # the last luma AC refinement
  # PIL decodes it (libjpeg smooths the blocks whose AC bits are missing).
  Image.open(io.BytesIO(cut)).convert("RGB").load()
  with pytest.raises(ValueError, match="block smoothing"):
    jpeg.decode(cut)
  # The whole script leaves nothing to smooth.
  np.testing.assert_array_equal(
      jpeg.decode(data), np.asarray(Image.open(io.BytesIO(data)).convert(
          "RGB")))


@pytest.mark.parametrize("where", ["headers", "first-scan", "mid-file",
                                   "before-eoi"])
def test_a_truncated_progressive_file_raises(where):
  data = _file((97, 61), "4:2:0", True, seed=5)
  offs = _scan_headers(data)
  cut = {"headers": offs[0] - 8, "first-scan": offs[0] + 20,
         "mid-file": len(data) // 2, "before-eoi": len(data) - 2}[where]
  with pytest.raises(ValueError, match="truncated JPEG"):
    jpeg.decode(data[:cut])


def test_every_truncation_point_of_a_progressive_file_raises():
  data = _file((40, 24), "4:2:0", False, seed=7)
  for cut in range(0, len(data) - 2, 5):
    with pytest.raises(ValueError):
      jpeg.decode(data[:cut])


@pytest.mark.parametrize("field,value,match", [
    ("se", 70, "illegal progressive scan"),          # Se past 63
    ("ss_gt_se", None, "illegal progressive scan"),  # Ss > Se
    ("al", 14, "illegal progressive scan"),          # Al past 13
    ("ah", 0x31, "illegal progressive scan"),        # Ah != Al + 1
    ("dc_band", None, "illegal progressive scan"),   # DC scan with Se != 0
])
def test_illegal_spectral_selection_or_approximation_raises(field, value,
                                                           match):
  data = bytearray(_file((97, 61), "4:4:4", False, seed=8))
  offs = _scan_headers(bytes(data))
  ac = offs[1]  # the first AC scan: Ss=1, Se=5, Ah=0, Al=2
  if field == "se":
    data[ac + 1] = value
  elif field == "ss_gt_se":
    data[ac], data[ac + 1] = 9, 5
  elif field == "al":
    data[ac + 2] = value
  elif field == "ah":
    data[ac + 2] = value
  else:
    data[offs[0] + 1] = 5
  with pytest.raises(ValueError, match=match):
    jpeg.decode(bytes(data))


def test_a_bogus_successive_approximation_raises():
  # The second scan refines bits the first never sent.
  data = _file((97, 61), "4:4:4", False, seed=9)
  offs = _scan_headers(data)
  out = bytearray(data)
  out[offs[1] + 2] = 0x21  # Ah=2, Al=1 on an AC band not yet coded
  with pytest.raises(ValueError, match="bogus progressive"):
    jpeg.decode(bytes(out))


def test_arithmetic_coded_progressive_is_refused_by_name():
  data = bytearray(_file((97, 61), "4:2:0", False))
  i = bytes(data).index(b"\xff\xc2")
  data[i + 1] = 0xCA  # SOF10: progressive, arithmetic-coded
  with pytest.raises(ValueError, match=r"arithmetic-coded JPEG \(SOF10\)"):
    jpeg.decode(bytes(data))


def test_twelve_bit_progressive_is_refused_by_name():
  data = bytearray(_file((97, 61), "4:2:0", False))
  i = bytes(data).index(b"\xff\xc2")
  data[i + 4] = 12
  with pytest.raises(ValueError, match=r"12-bit JPEG \(SOF2\)"):
    jpeg.decode(bytes(data))


# The committed fixture that chip_smoke.py's phase input decodes on the
# card's host (where there is no PIL): a 97x61 4:2:0 progressive file with
# restart intervals, written by PIL; the SHA-256 of PIL's RGB pixels.
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "progressive_97x61.jpg")
FIXTURE_PIL_SHA256 = (
    "036969b271c389484c1cb94d7aa3c30b6996a56789ee912bebfd8e716be30412")


def test_the_committed_fixture_is_pils_and_the_ports():
  with open(FIXTURE, "rb") as f:
    data = f.read()
  assert data[data.index(b"\xff\xc2") + 1] == 0xC2
  pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
  assert hashlib.sha256(pil.tobytes()).hexdigest() == FIXTURE_PIL_SHA256
  assert hashlib.sha256(jpeg.decode(data).tobytes()).hexdigest() == \
      FIXTURE_PIL_SHA256
