"""Model registry: dataset-keyed name -> constructor maps, with the JAX
package's names (kf_benchmarks_tpu/models/model_config.py:31-84).

``_MODELS`` is the ImageNet map (also synthetic ImageNet), ``_CIFAR_MODELS``
the CIFAR-10 map, ``_COCO_MODELS`` the COCO map (SSD300), ``_SPEECH_MODELS``
the LibriSpeech map (DeepSpeech2). Each entry is called with the run's
Params (or None), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from kf_benchmarks_tpu_torch.models import alexnet_model
from kf_benchmarks_tpu_torch.models import deepspeech
from kf_benchmarks_tpu_torch.models import densenet_model
from kf_benchmarks_tpu_torch.models import googlenet_model
from kf_benchmarks_tpu_torch.models import inception_model
from kf_benchmarks_tpu_torch.models import lenet_model
from kf_benchmarks_tpu_torch.models import mobilenet_v2
from kf_benchmarks_tpu_torch.models import nasnet_model
from kf_benchmarks_tpu_torch.models import official_ncf_model
from kf_benchmarks_tpu_torch.models import official_resnet_model
from kf_benchmarks_tpu_torch.models import overfeat_model
from kf_benchmarks_tpu_torch.models import resnet_model
from kf_benchmarks_tpu_torch.models import ssd_model
from kf_benchmarks_tpu_torch.models import transformer_lm
from kf_benchmarks_tpu_torch.models import trivial_model
from kf_benchmarks_tpu_torch.models import vgg_model

_MODELS: Dict[str, Callable] = {
    "vgg11": vgg_model.Vgg11Model,
    "vgg16": vgg_model.Vgg16Model,
    "vgg19": vgg_model.Vgg19Model,
    "lenet": lenet_model.Lenet5Model,
    "googlenet": googlenet_model.GooglenetModel,
    "overfeat": overfeat_model.OverfeatModel,
    "alexnet": alexnet_model.AlexnetModel,
    "trivial": trivial_model.TrivialModel,
    "inception3": inception_model.Inceptionv3Model,
    "inception4": inception_model.Inceptionv4Model,
    "mobilenet": mobilenet_v2.create_mobilenet_model,
    "nasnet": nasnet_model.create_nasnet_model,
    "nasnetlarge": nasnet_model.create_nasnetlarge_model,
    "ncf": official_ncf_model.create_ncf_model,
    "transformer_lm": transformer_lm.create_transformer_lm_model,
    "resnet50": resnet_model.create_resnet50_model,
    "resnet50_v1.5": resnet_model.create_resnet50_v15_model,
    "resnet50_v2": resnet_model.create_resnet50_v2_model,
    "resnet101": resnet_model.create_resnet101_model,
    "resnet101_v2": resnet_model.create_resnet101_v2_model,
    "resnet152": resnet_model.create_resnet152_model,
    "resnet152_v2": resnet_model.create_resnet152_v2_model,
    "official_resnet18": official_resnet_model.create_official_resnet18_model,
    "official_resnet34": official_resnet_model.create_official_resnet34_model,
    "official_resnet50": official_resnet_model.create_official_resnet50_model,
    "official_resnet50_v2":
        official_resnet_model.create_official_resnet50_v2_model,
    "official_resnet101":
        official_resnet_model.create_official_resnet101_model,
    "official_resnet152":
        official_resnet_model.create_official_resnet152_model,
    "official_resnet200":
        official_resnet_model.create_official_resnet200_model,
}

_CIFAR_MODELS: Dict[str, Callable] = {
    "alexnet": alexnet_model.AlexnetCifar10Model,
    "trivial": trivial_model.TrivialCifar10Model,
    "nasnet": nasnet_model.create_nasnet_cifar_model,
    "densenet40_k12": densenet_model.create_densenet40_k12_model,
    "densenet100_k12": densenet_model.create_densenet100_k12_model,
    "densenet100_k24": densenet_model.create_densenet100_k24_model,
    "resnet20": resnet_model.create_resnet20_cifar_model,
    "resnet20_v2": resnet_model.create_resnet20_v2_cifar_model,
    "resnet32": resnet_model.create_resnet32_cifar_model,
    "resnet32_v2": resnet_model.create_resnet32_v2_cifar_model,
    "resnet44": resnet_model.create_resnet44_cifar_model,
    "resnet44_v2": resnet_model.create_resnet44_v2_cifar_model,
    "resnet56": resnet_model.create_resnet56_cifar_model,
    "resnet56_v2": resnet_model.create_resnet56_v2_cifar_model,
    "resnet110": resnet_model.create_resnet110_cifar_model,
    "resnet110_v2": resnet_model.create_resnet110_v2_cifar_model,
}

_COCO_MODELS: Dict[str, Callable] = {
    "ssd300": ssd_model.create_ssd300_model,
}

_SPEECH_MODELS: Dict[str, Callable] = {
    "deepspeech2": deepspeech.create_deepspeech2_model,
}


def _model_map(dataset_name: Optional[str]) -> Dict[str, Callable]:
  if dataset_name == "cifar10":
    return _CIFAR_MODELS
  if dataset_name == "coco":
    return _COCO_MODELS
  if dataset_name == "librispeech":
    return _SPEECH_MODELS
  if dataset_name in ("imagenet", "synthetic", None):
    return _MODELS
  raise ValueError(f"Invalid dataset name: {dataset_name}")


def get_model_config(model_name: str, params=None,
                     dataset_name: Optional[str] = None):
  """The model ``model_name`` of ``dataset_name``'s map (ImageNet when
  None)."""
  model_map = _model_map(dataset_name)
  if model_name not in model_map:
    raise ValueError(f"Invalid model name '{model_name}' for dataset "
                     f"'{dataset_name or 'imagenet'}' (the port runs "
                     f"{', '.join(list_models(dataset_name))})")
  return model_map[model_name](params)


def list_models(dataset_name: Optional[str] = None):
  return sorted(_model_map(dataset_name))
