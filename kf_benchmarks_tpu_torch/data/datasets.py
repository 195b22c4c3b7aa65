"""Dataset registry: the port's copy of the JAX package's data/datasets.py.

A dataset is synthetic iff it has no data_dir (ref: datasets.py:82-83);
``create_dataset`` maps a name to its class, sniffing the name from the
data_dir's base name when --data_name is unset (ref: datasets.py:208-251).
``num_examples_per_epoch`` keeps ImageNet's counts for the callers that
count epochs of the default dataset (the learning-rate policy,
--num_epochs, --num_eval_epochs).
"""

from __future__ import annotations

import os
from typing import Optional


class Dataset:
  """Abstract dataset (ref: datasets.py:44-121)."""

  def __init__(self, name: str, data_dir: Optional[str] = None,
               num_classes: int = 1000):
    self.name = name
    self.data_dir = data_dir
    self._num_classes = num_classes

  def use_synthetic_gpu_inputs(self) -> bool:
    """Synthetic iff no data_dir (ref: datasets.py:82-83)."""
    return not self.data_dir

  @property
  def num_classes(self) -> int:
    return self._num_classes

  @num_classes.setter
  def num_classes(self, val: int) -> None:
    self._num_classes = val

  def num_examples_per_epoch(self, subset: str = "train") -> int:
    raise NotImplementedError

  def get_input_preprocessor(self, input_preprocessor: str = "default"):
    """The preprocessor class, resolved lazily so that a synthetic run never
    imports the pipeline."""
    from kf_benchmarks_tpu_torch.data import preprocessing  # noqa: PLC0415
    return preprocessing.get_preprocessor(self.name, input_preprocessor)

  def __str__(self):
    return self.name


class ImagenetDataset(Dataset):
  """(ref: datasets.py:124-137)"""

  def __init__(self, data_dir=None):
    # 1001 classes: TFRecord labels are 1-based with 0 reserved for
    # background, and flow to the logits unshifted.
    super().__init__("imagenet", data_dir, num_classes=1001)

  def num_examples_per_epoch(self, subset="train"):
    if subset == "train":
      return 1281167
    if subset == "validation":
      return 50000
    raise ValueError(f"Invalid data subset {subset!r}")


class Cifar10Dataset(Dataset):
  """(ref: datasets.py:140-189)"""

  def __init__(self, data_dir=None):
    super().__init__("cifar10", data_dir, num_classes=10)

  def num_examples_per_epoch(self, subset="train"):
    if subset == "train":
      return 50000
    if subset == "validation":
      return 10000
    raise ValueError(f"Invalid data subset {subset!r}")


class COCODataset(Dataset):
  """(ref: datasets.py:192-205)"""

  def __init__(self, data_dir=None):
    super().__init__("coco", data_dir, num_classes=81)

  def num_examples_per_epoch(self, subset="train"):
    if subset == "train":
      return 118287
    if subset == "validation":
      return 4952
    raise ValueError(f"Invalid data subset {subset!r}")


class LibrispeechDataset(Dataset):
  """(ref: datasets.py:86-103)"""

  def __init__(self, data_dir=None):
    super().__init__("librispeech", data_dir, num_classes=29)

  def num_examples_per_epoch(self, subset="train"):
    if subset == "train":
      return 281241
    if subset == "validation":
      return 5567
    raise ValueError(f"Invalid data subset {subset!r}")


_DATASETS = {
    "imagenet": ImagenetDataset,
    "cifar10": Cifar10Dataset,
    "coco": COCODataset,
    "librispeech": LibrispeechDataset,
}


def create_dataset(data_dir: Optional[str],
                   data_name: Optional[str]) -> Dataset:
  """Name->class with dir-name sniffing (ref: datasets.py:232-251)."""
  if not data_dir and not data_name:
    data_name = "imagenet"  # synthetic default (ref :236-237)
  if data_name == "synthetic":
    # Accepted wherever model_config accepts it: synthetic imagenet.
    data_name, data_dir = "imagenet", None
  if data_name is None:
    for name in _DATASETS:
      if name in os.path.basename(data_dir).lower():
        data_name = name
        break
    else:
      raise ValueError(
          f"Could not identify name of dataset. Please specify with "
          f"--data_name option. data_dir={data_dir}")
  if data_name not in _DATASETS:
    raise ValueError(f"Unknown dataset. Must be one of "
                     f"{sorted(_DATASETS)}, got {data_name!r}")
  return _DATASETS[data_name](data_dir)


def num_examples_per_epoch(subset: str = "train") -> int:
  """ImageNet examples in one epoch of ``subset`` ('train' or
  'validation')."""
  return ImagenetDataset().num_examples_per_epoch(subset)
