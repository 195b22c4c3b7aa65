"""SSD anchors, target assignment and box coding: the port's copy of
kf_benchmarks_tpu/models/ssd_dataloader.py.

The anchors (``DefaultBoxes``, 8732 of them), the IoU matrix, the box
encoding and the label assignment are numpy on the host input path, as in
the JAX package; ``decode_boxes`` is torch, so the evaluation decodes on
the card (torch is imported there alone: the input path imports this
module and no torch).

Ordering: anchors, head outputs and targets all use location-major order
(feature map -> grid (i, j) -> default box), the order DefaultBoxes
produces (the JAX package's note: the reference's own model flattens its
NCHW heads defaults-major, against its anchor order; both packages keep
the two consistent instead).
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import numpy as np

from kf_benchmarks_tpu_torch.models import ssd_constants


class DefaultBoxes:
  """The 8732 SSD300 anchors (ssd_dataloader.py:32-65 of the JAX package)."""

  def __init__(self):
    fk = ssd_constants.IMAGE_SIZE / np.array(ssd_constants.STEPS)
    boxes = []
    for idx, feature_size in enumerate(ssd_constants.FEATURE_SIZES):
      sk1 = ssd_constants.SCALES[idx] / ssd_constants.IMAGE_SIZE
      sk2 = ssd_constants.SCALES[idx + 1] / ssd_constants.IMAGE_SIZE
      sk3 = math.sqrt(sk1 * sk2)
      all_sizes = [(sk1, sk1), (sk3, sk3)]
      for alpha in ssd_constants.ASPECT_RATIOS[idx]:
        w, h = sk1 * math.sqrt(alpha), sk1 / math.sqrt(alpha)
        all_sizes.append((w, h))
        all_sizes.append((h, w))
      assert len(all_sizes) == ssd_constants.NUM_DEFAULTS[idx]
      for i, j in itertools.product(range(feature_size), repeat=2):
        cx, cy = (j + 0.5) / fk[idx], (i + 0.5) / fk[idx]
        for w, h in all_sizes:
          boxes.append((cy, cx, h, w))
    assert len(boxes) == ssd_constants.NUM_SSD_BOXES
    self.default_boxes_cychw = np.clip(
        np.asarray(boxes, np.float32), 0.0, 1.0)

  def __call__(self, order: str = "ltrb") -> np.ndarray:
    """[N, 4] anchors; 'ltrb' = (ymin, xmin, ymax, xmax), 'xywh' =
    (cy, cx, h, w)."""
    if order == "xywh":
      return self.default_boxes_cychw
    cy, cx, h, w = np.split(self.default_boxes_cychw, 4, axis=-1)
    return np.concatenate(
        [cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], axis=-1)


def calc_iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
  """Pairwise IoU of [N,4] x [M,4] ltrb boxes (ref: calc_iou_tensor,
  ssd_dataloader.py:81-112)."""
  b1 = boxes1[:, None, :]
  b2 = boxes2[None, :, :]
  tl = np.maximum(b1[..., :2], b2[..., :2])
  br = np.minimum(b1[..., 2:], b2[..., 2:])
  wh = np.clip(br - tl, 0.0, None)
  inter = wh[..., 0] * wh[..., 1]
  area1 = ((boxes1[:, 2] - boxes1[:, 0]) *
           (boxes1[:, 3] - boxes1[:, 1]))[:, None]
  area2 = ((boxes2[:, 2] - boxes2[:, 0]) *
           (boxes2[:, 3] - boxes2[:, 1]))[None, :]
  return inter / np.clip(area1 + area2 - inter, 1e-12, None)


def encode_boxes(boxes_cychw: np.ndarray,
                 anchors_cychw: np.ndarray) -> np.ndarray:
  """Faster-RCNN box coding with SSD scales (ref: encode_labels's
  FasterRcnnBoxCoder scale_factors, ssd_dataloader.py:273-289)."""
  scales = np.asarray(ssd_constants.BOX_CODER_SCALES, np.float32)
  ty = (boxes_cychw[..., 0] - anchors_cychw[..., 0]) / anchors_cychw[..., 2]
  tx = (boxes_cychw[..., 1] - anchors_cychw[..., 1]) / anchors_cychw[..., 3]
  th = np.log(np.clip(boxes_cychw[..., 2], 1e-8, None) /
              anchors_cychw[..., 2])
  tw = np.log(np.clip(boxes_cychw[..., 3], 1e-8, None) /
              anchors_cychw[..., 3])
  return np.stack([ty * scales[0], tx * scales[1],
                   th * scales[2], tw * scales[3]], axis=-1)


def decode_boxes(encoded, anchors_cychw):
  """Inverse of encode_boxes, in torch on the encodings' device (f32).
  Returns ltrb boxes."""
  import torch  # noqa: PLC0415
  scales = ssd_constants.BOX_CODER_SCALES
  anchors = torch.as_tensor(anchors_cychw, dtype=torch.float32,
                            device=encoded.device)
  cy = encoded[..., 0] / scales[0] * anchors[..., 2] + anchors[..., 0]
  cx = encoded[..., 1] / scales[1] * anchors[..., 3] + anchors[..., 1]
  h = torch.exp(encoded[..., 2] / scales[2]) * anchors[..., 2]
  w = torch.exp(encoded[..., 3] / scales[3]) * anchors[..., 3]
  return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2],
                     dim=-1)


def _ltrb_to_cychw(boxes: np.ndarray) -> np.ndarray:
  ymin, xmin, ymax, xmax = np.split(boxes, 4, axis=-1)
  return np.concatenate([(ymin + ymax) / 2, (xmin + xmax) / 2,
                         ymax - ymin, xmax - xmin], axis=-1)


def encode_labels(gt_boxes: np.ndarray, gt_labels: np.ndarray,
                  default_boxes: DefaultBoxes = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Assign ground truth to anchors and encode regression targets
  (ref: encode_labels, ssd_dataloader.py:257-320).

  Args:
    gt_boxes: [M, 4] ltrb in [0, 1].
    gt_labels: [M] int class ids (contiguous, 1-based; 0 = background).
  Returns:
    (encoded_boxes [N,4], classes [N], num_matched scalar): anchors with
    IoU >= MATCH_THRESHOLD against some gt box get that box's encoded
    coordinates and label; the rest are background (class 0).
  """
  db = default_boxes or _default_boxes_singleton()
  anchors_ltrb = db("ltrb")
  anchors_cychw = db("xywh")
  n = anchors_ltrb.shape[0]
  classes = np.zeros((n,), np.int32)
  encoded = np.zeros((n, 4), np.float32)
  if gt_boxes.shape[0] == 0:
    return encoded, classes, np.float32(1.0)
  iou = calc_iou_matrix(anchors_ltrb, gt_boxes.astype(np.float32))
  best_gt = iou.argmax(axis=1)
  best_iou = iou.max(axis=1)
  matched = best_iou >= ssd_constants.MATCH_THRESHOLD
  # Every gt box claims its best anchor even below threshold (standard
  # SSD bipartite step, as in the object_detection target assigner).
  forced = iou.argmax(axis=0)
  matched[forced] = True
  best_gt[forced] = np.arange(gt_boxes.shape[0])
  classes[matched] = gt_labels[best_gt[matched]].astype(np.int32)
  gt_cychw = _ltrb_to_cychw(gt_boxes.astype(np.float32))
  encoded[matched] = encode_boxes(gt_cychw[best_gt[matched]],
                                  anchors_cychw[matched])
  return encoded, classes, np.float32(max(matched.sum(), 1))


_SINGLETON = None


def _default_boxes_singleton() -> DefaultBoxes:
  global _SINGLETON
  if _SINGLETON is None:
    _SINGLETON = DefaultBoxes()
  return _SINGLETON
