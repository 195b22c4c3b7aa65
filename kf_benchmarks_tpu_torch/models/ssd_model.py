"""SSD300 with the modified ResNet-34 backbone (COCO detection): the port's
counterpart of kf_benchmarks_tpu/models/ssd_model.py.

The network is recorded through builder.ConvNetBuilder as the JAX module
builds it, so its layers carry the JAX builder's names (``conv0``,
``resblk<k>_a`` ..., ``conv<n>`` for the extra layers and the heads) and
convert.py maps them one to one:

* the backbone (ssd_model.py:53-62 there): a 7x7/2 conv, a 3x3/2 max pool,
  then ResNet-34 v1's basic blocks, 3 at 64 channels, 4 at 128 (the first
  at stride 2) and 6 at 256, all at stride 1: the 38x38 map survives and
  group 4 is gone;
* the extra layers (1x1 then 3x3, ReLU, no batch norm) down to 19, 10, 5,
  3 and 1;
* the multibox heads: a 3x3 conv of 4 x defaults and one of 81 x defaults
  on each of the six maps, flattened location-major (NHWC order) to agree
  with ``ssd_dataloader.DefaultBoxes``, concatenated to [N, 8732, 4 + 81].

Routing (builder.fusable_conv3x3 and ConvNetBuilder.finish): the second
3x3 conv of each of the 13 basic blocks is a stride-1 3x3 after its
block's first conv, batch norm and ReLU, at 64, 128 or 256 channels, so
it runs as the fused unit: 13 K-B and 13 K-A launches a training step
(13 K-B an evaluation forward). No other conv qualifies: the blocks' first
convs read a residual sum, the extra layers and the heads have no batch
norm before them, and the 3x3 extra layers at stride 1 are VALID. The
heads (16-24 and 324-486 output channels) stay cuDNN.

The labels are the tuple (encoded boxes [N, 8732, 4], classes [N, 8732],
matched anchors [N]); the loss is smooth-L1 localisation over the matched
anchors plus softmax cross-entropy with 3:1 hard-negative mining (the
double-argsort rank), each divided by the matched count (ssd_model.py:
151-193 there).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from kf_benchmarks_tpu_torch.models import builder
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import ssd_constants
from kf_benchmarks_tpu_torch.models import ssd_dataloader
from kf_benchmarks_tpu_torch.ops.conv_bn import accum

class SSDNet(builder.GraphNet):
  """The recorded SSD300: NHWC images -> f32 [N, 8732, 4 + label_num]."""

  def __init__(self, dtype: torch.dtype, label_num: int):
    super().__init__(dtype)
    self.label_num = label_num

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    return flatten_heads(super().forward(images), self.label_num)


def flatten_heads(heads, label_num: int) -> torch.Tensor:
  """The heads' outputs (NCHW-shaped; location, class, location, ... per
  map) -> [N, boxes, 4 + label_num]: each flattened location-major
  (NHWC order, then the defaults), the maps concatenated."""
  n = heads[0].shape[0]
  locs = [builder.nhwc(h).reshape(n, -1, 4) for h in heads[0::2]]
  confs = [builder.nhwc(h).reshape(n, -1, label_num) for h in heads[1::2]]
  return torch.cat([torch.cat(locs, 1), torch.cat(confs, 1)], dim=2)


class SSD300Model(builder.BuilderModel):
  """SSD300 (ssd_model.py:101-299 of the JAX package)."""

  data_name = "coco"

  def __init__(self, label_num: int = ssd_constants.NUM_CLASSES,
               batch_size: int = 32, learning_rate: float = 1e-3,
               backbone: str = "resnet34", params=None):
    super().__init__("ssd300", 300, batch_size, learning_rate,
                     params=params)
    if backbone != "resnet34":
      raise ValueError(f"Unsupported backbone {backbone!r}")
    self.label_num = label_num

  def make_module(self, nclass, dtype=torch.float32, generator=None):
    del nclass  # label_num is COCO's
    net = SSDNet(dtype, self.label_num)
    cnn = builder.ConvNetBuilder(net, self.image_size, self.depth,
                                 generator=generator)
    cnn.use_batch_norm = True
    cnn.batch_norm_config = {"decay": ssd_constants.BATCH_NORM_DECAY,
                             "epsilon": ssd_constants.BATCH_NORM_EPSILON,
                             "scale": True}
    cnn.conv(64, 7, 7, 2, 2, mode="SAME_RESNET", use_batch_norm=True)
    cnn.mpool(3, 3, 2, 2, mode="SAME")
    for _ in range(3):
      resnet_model.residual_block(cnn, 64, 1, "v1")
    for i in range(4):
      resnet_model.residual_block(cnn, 128, 2 if i == 0 else 1, "v1")
    for _ in range(6):
      resnet_model.residual_block(cnn, 256, 1, "v1")

    def ssd_layer(depth, k, stride, mode):
      return cnn.conv(depth, k, k, stride, stride, mode=mode,
                      use_batch_norm=False)

    activations = [cnn.top]  # 38x38x256
    ssd_layer(256, 1, 1, "VALID")
    activations.append(ssd_layer(512, 3, 2, "SAME"))   # 19x19
    ssd_layer(256, 1, 1, "VALID")
    activations.append(ssd_layer(512, 3, 2, "SAME"))   # 10x10
    ssd_layer(128, 1, 1, "VALID")
    activations.append(ssd_layer(256, 3, 2, "SAME"))   # 5x5
    ssd_layer(128, 1, 1, "VALID")
    activations.append(ssd_layer(256, 3, 1, "VALID"))  # 3x3
    ssd_layer(128, 1, 1, "VALID")
    activations.append(ssd_layer(256, 3, 1, "VALID"))  # 1x1
    heads = []
    for nd, act in zip(ssd_constants.NUM_DEFAULTS, activations):
      heads.append(cnn.conv(nd * 4, 3, 3, 1, 1, input_layer=act,
                            activation=None, use_batch_norm=False))
      heads.append(cnn.conv(nd * self.label_num, 3, 3, 1, 1,
                            input_layer=act, activation=None,
                            use_batch_norm=False))
    return cnn.finish(heads).to(memory_format=torch.channels_last)

  # -- inputs ---------------------------------------------------------------

  def get_input_shapes(self, subset):
    """images and (encoded boxes, classes, matched anchors)
    (ssd_model.py:131-137)."""
    del subset
    n = self.get_batch_size()
    return [[n, self.image_size, self.image_size, self.depth],
            [n, ssd_constants.NUM_SSD_BOXES, 4],
            [n, ssd_constants.NUM_SSD_BOXES],
            [n]]

  def get_synthetic_inputs(self, generator: torch.Generator, nclass: int,
                           device: torch.device):
    """Uniform images in [0, 1) and a random target set: about 1% of the
    anchors matched to a class in [1, label_num), boxes zero
    (ssd_model.py:142-149)."""
    del nclass
    shapes = self.get_input_shapes("train")
    images = torch.rand(shapes[0], generator=generator, device=device)
    boxes = torch.zeros(shapes[1], device=device)
    draw = torch.rand(shapes[2], generator=generator, device=device)
    cls = torch.randint(1, self.label_num, shapes[2], generator=generator,
                        device=device)
    classes = torch.where(draw > 0.99, cls, torch.zeros_like(cls))
    num_matched = torch.clamp((classes > 0).float().sum(1), min=1.0)
    return images, (boxes, classes, num_matched)

  # -- the loss (ssd_model.py:151-193) --------------------------------------

  def loss_function(self, logits, labels) -> torch.Tensor:
    logits = accum(logits)
    pred_loc, pred_label = logits[..., :4], logits[..., 4:]
    gt_loc, gt_label, num_matched = labels
    gt_label = gt_label.long()
    return (self._localization_loss(pred_loc, gt_loc, gt_label, num_matched)
            + self._classification_loss(pred_label, gt_label, num_matched))

  @staticmethod
  def _localization_loss(pred_loc, gt_loc, gt_label, num_matched):
    """Smooth-L1 over the matched anchors."""
    mask = (gt_label > 0).float()
    diff = pred_loc - gt_loc
    abs_diff = diff.abs()
    huber = torch.where(abs_diff < 1.0, 0.5 * diff * diff, abs_diff - 0.5)
    per_image = (huber.sum(2) * mask).sum(1)
    return (per_image / num_matched).mean()

  @staticmethod
  def _classification_loss(pred_label, gt_label, num_matched):
    """Softmax cross-entropy with 3:1 hard negative mining: each
    negative anchor ranked by its loss (argsort of the argsort), the top
    3 x matched kept."""
    logp = F.log_softmax(pred_label, dim=-1)
    xent = -torch.gather(logp, 2, gt_label.unsqueeze(-1)).squeeze(-1)
    mask = (gt_label > 0).float()
    neg_xent = xent * (1.0 - mask)
    order = torch.argsort(-neg_xent, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    num_negs = torch.clamp(num_matched * ssd_constants.NEGS_PER_POSITIVE,
                           max=ssd_constants.NUM_SSD_BOXES)
    top_k_neg_mask = (rank < num_negs[:, None].to(rank.dtype)).float()
    per_image = (xent * (mask + top_k_neg_mask)).sum(1)
    return (per_image / num_matched).mean()

  # -- the rate (ssd_model.py:195-206) --------------------------------------

  def get_scaled_base_learning_rate(self, batch_size):
    return self.learning_rate * batch_size / 32.0

  def get_learning_rate(self, global_step, batch_size):
    """The MLPerf schedule at the batch's scaled rate; a tensor step gives
    the device form."""
    schedule = ssd_constants.LEARNING_RATE_SCHEDULE
    factor = self.get_scaled_base_learning_rate(batch_size) / schedule[0][1]
    if isinstance(global_step, torch.Tensor):
      lr = torch.full((), schedule[0][1], dtype=torch.float32,
                      device=global_step.device)
      for boundary, value in schedule[1:]:
        lr = torch.where(global_step >= boundary,
                         torch.full_like(lr, value), lr)
      return lr * factor
    lr = schedule[0][1]
    for boundary, value in schedule[1:]:
      if global_step >= boundary:
        lr = value
    return float(np.float32(lr) * np.float32(factor))

  # -- evaluation (ssd_model.py:208-299) ------------------------------------

  def accuracy_function(self, logits, labels) -> Dict[str, torch.Tensor]:
    """For the shared eval loop on synthetic targets: the mean of each
    anchor's top class confidence as both "accuracies" (detection has no
    top-k; the mAP comes from ``evaluate_real_data``)."""
    del labels
    scores = F.softmax(accum(logits)[..., 4:], dim=-1)
    top_conf = scores[..., 1:].max(-1).values.mean()
    return {"top_1_accuracy": top_conf, "top_5_accuracy": top_conf}

  def postprocess(self, results: Dict) -> Dict:
    """The COCO mAP of the accumulated predictions (coco_metric)."""
    from kf_benchmarks_tpu_torch import coco_metric  # noqa: PLC0415
    return coco_metric.maybe_compute_map(results, self.params)

  def evaluate_real_data(self, module, params, dataset, device,
                         dtype: torch.dtype,
                         num_batches: Optional[int] = None) -> Dict:
    """Validation over the COCO records: the module in eval mode over the
    validation stream's batches (one pass), each decoded on the device and
    accumulated per image, then the mAP (ssd_model.py:248-299 there).
    ``num_batches`` caps the batches (None: the whole stream)."""
    from kf_benchmarks_tpu_torch.data import device_feed  # noqa: PLC0415
    from kf_benchmarks_tpu_torch.data import preprocessing  # noqa: PLC0415
    self.params = params
    pre = preprocessing.COCOPreprocessor(
        batch_size=self.get_batch_size(),
        output_shape=(self.image_size, self.image_size, self.depth),
        train=False, distortions=False, resize_method="bilinear",
        seed=params.tf_random_seed or 301, shift_ratio=0.0,
        num_threads=params.datasets_num_private_threads or 4)
    anchors = ssd_dataloader._default_boxes_singleton()("xywh")
    predictions: List[Dict] = []
    was_training = module.training
    module.eval()
    try:
      with torch.no_grad():
        for i, (images, (_, _, source_ids, raw_shapes)) in enumerate(
            pre.minibatches(dataset, "validation")):
          if num_batches and i >= num_batches:
            break
          x = device_feed.normalize(torch.from_numpy(images).to(device),
                                    pre.NORMALIZATION, dtype)
          logits = accum(module(x))
          decoded = ssd_dataloader.decode_boxes(logits[..., :4], anchors)
          scores = F.softmax(logits[..., 4:], dim=-1)
          decoded, scores = decoded.cpu().numpy(), scores.cpu().numpy()
          for b in range(len(images)):
            predictions.append({
                "source_id": int(source_ids[b]),
                "pred_boxes": decoded[b],
                "pred_scores": scores[b],
                "raw_shape": np.asarray(raw_shapes[b]),
            })
    finally:
      module.train(was_training)
    return self.postprocess({"predictions": predictions,
                             "num_eval_images": len(predictions)})


def create_ssd300_model(params=None):
  return SSD300Model(params=params)
