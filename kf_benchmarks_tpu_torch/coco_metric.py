"""COCO mAP: the port's copy of kf_benchmarks_tpu/coco_metric.py.

Host-side numpy: the per-class non-max suppression and score filter
(``nms``, ``select_detections``), the detections in COCO's result rows, and
the mAP of them against an ``instances`` annotation file: through
pycocotools where it is installed, else through ``compute_map_numpy``, a
numpy re-implementation of COCOeval's bbox protocol (the JAX package's
fallback, copied here). Without the annotation file or any detection the
results pass through with a note instead of an mAP.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from kf_benchmarks_tpu_torch.models import ssd_constants
from kf_benchmarks_tpu_torch.models import ssd_dataloader
from kf_benchmarks_tpu_torch.utils import log as log_util


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float = ssd_constants.OVERLAP_CRITERIA,
        max_out: int = ssd_constants.MAX_NUM_EVAL_BOXES) -> List[int]:
  """Greedy per-class NMS over ltrb boxes; returns kept indices."""
  order = np.argsort(-scores)
  keep: List[int] = []
  while order.size and len(keep) < max_out:
    i = order[0]
    keep.append(int(i))
    if order.size == 1:
      break
    rest = order[1:]
    iou = ssd_dataloader.calc_iou_matrix(boxes[i:i + 1], boxes[rest])[0]
    order = rest[iou <= iou_threshold]
  return keep


def select_detections(pred_boxes: np.ndarray, pred_scores: np.ndarray
                      ) -> List[Dict]:
  """Per-class score filter + NMS; detections as COCO-style dicts with
  normalized ltrb boxes and contiguous labels."""
  detections = []
  num_classes = pred_scores.shape[-1]
  for cls in range(1, num_classes):
    scores = pred_scores[:, cls]
    sel = scores > ssd_constants.MIN_SCORE
    if not np.any(sel):
      continue
    idx = np.nonzero(sel)[0]
    kept = nms(pred_boxes[idx], scores[idx])
    for k in kept:
      i = idx[k]
      detections.append({
          "label": cls,
          "score": float(scores[i]),
          "bbox_ltrb": pred_boxes[i].tolist(),
      })
  detections.sort(key=lambda d: -d["score"])
  return detections[:ssd_constants.MAX_NUM_EVAL_BOXES]


def _build_detections(predictions) -> List[List[float]]:
  """Accumulated per-image predictions -> COCO result rows
  [image_id, x, y, w, h, score, category_id] in pixel coords."""
  detections = []
  for p in predictions:
    h, w = p["raw_shape"][:2]
    for d in select_detections(np.asarray(p["pred_boxes"]),
                               np.asarray(p["pred_scores"])):
      ymin, xmin, ymax, xmax = d["bbox_ltrb"]
      detections.append([
          int(p["source_id"]),
          xmin * w, ymin * h, (xmax - xmin) * w, (ymax - ymin) * h,
          d["score"],
          ssd_constants.CLASS_INV_MAP[d["label"]],
      ])
  return detections


def _iou_xywh(det: np.ndarray, gts: np.ndarray) -> np.ndarray:
  """IoU of one [4] xywh box against [M,4] xywh boxes."""
  x0 = np.maximum(det[0], gts[:, 0])
  y0 = np.maximum(det[1], gts[:, 1])
  x1 = np.minimum(det[0] + det[2], gts[:, 0] + gts[:, 2])
  y1 = np.minimum(det[1] + det[3], gts[:, 1] + gts[:, 3])
  inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
  union = det[2] * det[3] + gts[:, 2] * gts[:, 3] - inter
  return inter / np.clip(union, 1e-12, None)


_IOU_THRS = np.arange(0.5, 1.0, 0.05)
_RECALL_THRS = np.linspace(0.0, 1.0, 101)


_MAX_DETS = 100  # COCOeval maxDets for the headline AP


def compute_map_numpy(gt_json: dict, detections: List[List[float]]) -> dict:
  """COCO bbox AP without pycocotools.

  Pure-numpy re-implementation of COCOeval's bbox protocol: top-100
  detections per image, greedy score-ordered matching per image/category
  at IoU thresholds .50:.05:.95, detections unmatched to real ground
  truth but overlapping an iscrowd region are ignored (neither TP nor
  FP; crowd overlap uses intersection/det_area as pycocotools does),
  101-point interpolated precision averaged over categories present in
  the ground truth. pycocotools (C) is what the reference uses
  (ref: coco_metric.py:33-178); it is not in this image, so this
  fallback keeps the mAP path executable end-to-end.
  """
  gt_by_img_cat = {}
  crowd_by_img_cat = {}
  cats_with_gt = set()
  for ann in gt_json.get("annotations", []):
    key = (int(ann["image_id"]), int(ann["category_id"]))
    if ann.get("iscrowd"):
      crowd_by_img_cat.setdefault(key, []).append(ann["bbox"])
    else:
      gt_by_img_cat.setdefault(key, []).append(ann["bbox"])
      cats_with_gt.add(int(ann["category_id"]))

  # maxDets cap: keep each image's top-100 detections by score.
  det_by_img = {}
  for row in detections:
    det_by_img.setdefault(int(row[0]), []).append(row)
  det_by_cat = {}
  for img, rows in det_by_img.items():
    rows.sort(key=lambda r: -r[5])
    for row in rows[:_MAX_DETS]:
      det_by_cat.setdefault(int(row[6]), []).append(row)

  ap_per_cat_thr = []  # [cats, thrs]
  for cat in sorted(cats_with_gt):
    rows = sorted(det_by_cat.get(cat, []), key=lambda r: -r[5])
    n_gt = sum(len(v) for (img, c), v in gt_by_img_cat.items() if c == cat)
    if n_gt == 0:
      continue
    # IoUs are threshold-independent: compute each detection's IoU
    # vector against its image's gt (and crowd overlap) exactly once.
    gt_arrays = {}
    det_ious = []      # per detection: (image_id, iou vector over gts)
    det_crowd = []     # per detection: max intersection/det_area vs crowds
    for row in rows:
      img = int(row[0])
      if img not in gt_arrays:
        gt_arrays[img] = np.asarray(gt_by_img_cat.get((img, cat), []),
                                    np.float64).reshape(-1, 4)
      gts = gt_arrays[img]
      det = np.asarray(row[1:5], np.float64)
      det_ious.append((img, _iou_xywh(det, gts) if len(gts) else
                       np.zeros((0,))))
      crowds = np.asarray(crowd_by_img_cat.get((img, cat), []),
                          np.float64).reshape(-1, 4)
      if len(crowds) and det[2] * det[3] > 0:
        x0 = np.maximum(det[0], crowds[:, 0])
        y0 = np.maximum(det[1], crowds[:, 1])
        x1 = np.minimum(det[0] + det[2], crowds[:, 0] + crowds[:, 2])
        y1 = np.minimum(det[1] + det[3], crowds[:, 1] + crowds[:, 3])
        inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
        det_crowd.append(float(np.max(inter / (det[2] * det[3]))))
      else:
        det_crowd.append(0.0)
    aps = np.zeros(len(_IOU_THRS))
    for ti, thr in enumerate(_IOU_THRS):
      matched = {}  # image_id -> set of matched gt indices
      tp = np.zeros(len(rows))
      ignored = np.zeros(len(rows), bool)
      for di, (img, ious) in enumerate(det_ious):
        used = matched.setdefault(img, set())
        hit = False
        for gi in np.argsort(-ious):
          if ious[gi] >= thr and int(gi) not in used:
            used.add(int(gi))
            tp[di] = 1.0
            hit = True
            break
        if not hit and det_crowd[di] >= thr:
          ignored[di] = True  # crowd overlap: neither TP nor FP
      keep = ~ignored
      cum_tp = np.cumsum(tp[keep])
      cum_fp = np.cumsum(1.0 - tp[keep])
      recall = cum_tp / n_gt
      precision = cum_tp / np.clip(cum_tp + cum_fp, 1e-12, None)
      # Monotone-decreasing precision envelope, then 101-point sample.
      for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
      ap = 0.0
      for r in _RECALL_THRS:
        idx = np.searchsorted(recall, r, side="left")
        ap += precision[idx] if idx < len(precision) else 0.0
      aps[ti] = ap / len(_RECALL_THRS)
    ap_per_cat_thr.append(aps)
  if not ap_per_cat_thr:
    return {"COCO/AP": 0.0, "COCO/AP50": 0.0}
  stacked = np.stack(ap_per_cat_thr)  # [cats, thrs]
  return {"COCO/AP": float(stacked.mean()),
          "COCO/AP50": float(stacked[:, 0].mean())}


def maybe_compute_map(results: dict, params=None) -> dict:
  """Compute COCO mAP when possible; otherwise annotate and pass through
  (ref: coco_metric.py compute_map; async wrapper ssd_model.py:481-539).

  ``results`` carries accumulated per-image predictions under
  'predictions': a list of {source_id, pred_boxes, pred_scores,
  raw_shape}. Uses pycocotools when importable, else the in-repo numpy
  evaluator (results['coco_evaluator'] records which ran).
  """
  data_dir = getattr(params, "data_dir", None) if params else None
  annotation_path = (os.path.join(data_dir, ssd_constants.ANNOTATION_FILE)
                     if data_dir else None)
  if not annotation_path or not os.path.exists(annotation_path):
    results["coco_map_note"] = "annotation file not found; mAP skipped"
    return results
  predictions = results.get("predictions", [])
  if not predictions:
    # Skip before parsing the ~450k-annotation json for nothing.
    results["coco_map_note"] = "no detections accumulated"
    return results
  detections = _build_detections(predictions)
  if not detections:
    results["coco_map_note"] = "no detections accumulated"
    return results
  try:
    from pycocotools.coco import COCO
    from pycocotools.cocoeval import COCOeval
    coco_gt = COCO(annotation_path)
    coco_dt = coco_gt.loadRes(np.asarray(detections))
    coco_eval = COCOeval(coco_gt, coco_dt, iouType="bbox")
    coco_eval.evaluate()
    coco_eval.accumulate()
    coco_eval.summarize()
    results["COCO/AP"] = float(coco_eval.stats[0])
    results["COCO/AP50"] = float(coco_eval.stats[1])
    results["coco_evaluator"] = "pycocotools"
  except ImportError:
    import json
    with open(annotation_path) as f:
      gt_json = json.load(f)
    results.update(compute_map_numpy(gt_json, detections))
    results["coco_evaluator"] = "numpy"
  log_util.log_fn("COCO mAP: %.4f" % results["COCO/AP"])
  return results
