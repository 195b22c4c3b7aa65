"""Model registry: the models the port runs so far.

A subset of kf_benchmarks_tpu/models/model_config.py; names outside it are
rejected by validation.py. Each entry is called with the run's Params (or
None), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict

from kf_benchmarks_tpu_torch.models import inception_model
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import transformer_lm
from kf_benchmarks_tpu_torch.models import trivial_model

# Synthetic ImageNet: 1001 classes (label 0 is the background class of the
# TFRecord labels), as the JAX package's ImagenetDataset.
IMAGENET_NUM_CLASSES = 1001

_MODELS: Dict[str, Callable] = {
    "trivial": trivial_model.TrivialModel,
    "resnet50": resnet_model.create_resnet50_model,
    "resnet50_v1.5": resnet_model.create_resnet50_v15_model,
    "resnet50_v2": resnet_model.create_resnet50_v2_model,
    "resnet101": resnet_model.create_resnet101_model,
    "resnet101_v2": resnet_model.create_resnet101_v2_model,
    "resnet152": resnet_model.create_resnet152_model,
    "resnet152_v2": resnet_model.create_resnet152_v2_model,
    "inception3": inception_model.Inceptionv3Model,
    "transformer_lm": transformer_lm.create_transformer_lm_model,
}


def get_model_config(model_name: str, params=None):
  if model_name not in _MODELS:
    raise ValueError(f"Invalid model name '{model_name}' (the port runs "
                     f"{', '.join(list_models())})")
  return _MODELS[model_name](params)


def list_models():
  return sorted(_MODELS)
