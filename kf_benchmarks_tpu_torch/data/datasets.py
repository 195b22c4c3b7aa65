"""Epoch sizes of the dataset the zoo's synthetic inputs stand for.

The port's own copy of ImageNet's example counts in kf_benchmarks_tpu/data/
datasets.py:62-66. Every model of the port runs on synthetic ImageNet, as
every model of the JAX package does without --data_dir (create_dataset's
default, datasets.py:118-123), so the learning-rate policy, --num_epochs
and --num_eval_epochs count ImageNet epochs.
"""

from __future__ import annotations

_IMAGENET_TRAIN = 1281167
_IMAGENET_VALIDATION = 50000


def num_examples_per_epoch(subset: str = "train") -> int:
  """ImageNet examples in one epoch of ``subset`` ('train' or
  'validation')."""
  if subset == "train":
    return _IMAGENET_TRAIN
  if subset == "validation":
    return _IMAGENET_VALIDATION
  raise ValueError(f"Invalid data subset {subset!r}")
