"""Generated LibriSpeech records: the port's twin of
kf_benchmarks_tpu/data/librispeech_record_generator.py.

Writes the SequenceExample records that LibrispeechPreprocessor parses
(per-frame 161-bin spectrogram features as the sequence feature
``features``, context ``labels``, ``input_length`` and ``label_length``) in
``train-00000-of-00001`` and ``validation-00000-of-00001``: short random
utterances of ``min_frames``..``max_frames`` frames and 5..``max_label_len``
character labels in 1..27, drawn from one ``np.random.RandomState(seed)`` in
the JAX generator's order, so the files are the JAX generator's byte for
byte. Real LibriSpeech features come from an offline featurizer run over
the audio; these let the pipeline and the CTC training run without the
corpus.

Run: ``python -m kf_benchmarks_tpu_torch.data.librispeech_record_generator
DIR [--num_train N] [--num_validation N] [--seed S]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from kf_benchmarks_tpu_torch.data import example as example_lib
from kf_benchmarks_tpu_torch.data import tfrecord

NUM_FEATURE_BINS = 161
# Character labels 1..27 (0 is padding, 28 the CTC blank of the model's
# alphabet).
NUM_CHAR_CLASSES = 27


def write_fake_librispeech(data_dir: str, num_train: int = 8,
                           num_validation: int = 4,
                           min_frames: int = 40, max_frames: int = 120,
                           max_label_len: int = 30, seed: int = 0) -> None:
  os.makedirs(data_dir, exist_ok=True)
  rng = np.random.RandomState(seed)
  for subset, count in (("train", num_train),
                        ("validation", num_validation)):
    path = os.path.join(data_dir, f"{subset}-00000-of-00001")
    with tfrecord.TFRecordWriter(path) as w:
      for _ in range(count):
        t = int(rng.randint(min_frames, max_frames + 1))
        n = int(rng.randint(5, max_label_len + 1))
        frames = rng.randn(t, NUM_FEATURE_BINS).astype(np.float32)
        labels = rng.randint(1, NUM_CHAR_CLASSES + 1,
                             size=n).astype(np.int64)
        w.write(example_lib.encode_sequence_example(
            context={
                "labels": labels,
                "input_length": np.asarray([t], np.int64),
                "label_length": np.asarray([n], np.int64),
            },
            feature_lists={"features": [frames[i] for i in range(t)]}))


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("data_dir")
  ap.add_argument("--num_train", type=int, default=8)
  ap.add_argument("--num_validation", type=int, default=4)
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args(argv)
  write_fake_librispeech(args.data_dir, args.num_train, args.num_validation,
                         seed=args.seed)
  print(args.data_dir)
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
