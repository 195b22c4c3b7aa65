"""SSD300 constants: the port's copy of
kf_benchmarks_tpu/models/ssd_constants.py (the MLPerf single-stage
detector: SSD300 with a modified ResNet-34 backbone on COCO; anchor
scales per ssd.pytorch, normalization per torchvision).
"""

IMAGE_SIZE = 300

# 81 including the background class 0; not all COCO ids are used.
NUM_CLASSES = 81

# COCO category id <-> contiguous label mapping (ref: ssd_constants.py:31-39).
CLASS_INV_MAP = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90)
_MAP = {j: i for i, j in enumerate(CLASS_INV_MAP)}  # local helper
CLASS_MAP = tuple(_MAP.get(i, -1) for i in range(max(CLASS_INV_MAP) + 1))

NUM_SSD_BOXES = 8732

RESNET_DEPTH = 34

MIN_LEVEL = 3
MAX_LEVEL = 8

FEATURE_SIZES = (38, 19, 10, 5, 3, 1)
STEPS = (8, 16, 32, 64, 100, 300)
SCALES = (21, 45, 99, 153, 207, 261, 315)
ASPECT_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
NUM_DEFAULTS = (4, 6, 6, 6, 4, 4)
SCALE_XY = 0.1
SCALE_HW = 0.2
BOX_CODER_SCALES = (1 / SCALE_XY, 1 / SCALE_XY, 1 / SCALE_HW, 1 / SCALE_HW)
MATCH_THRESHOLD = 0.5

NORMALIZATION_MEAN = (0.485, 0.456, 0.406)
NORMALIZATION_STD = (0.229, 0.224, 0.225)

# SSD cropping (ref: ssd_crop, ssd_dataloader.py:114-228)
NUM_CROP_PASSES = 50
CROP_MIN_IOU_CHOICES = (0, 0.1, 0.3, 0.5, 0.7, 0.9)
P_NO_CROP_PER_PASS = 1 / (len(CROP_MIN_IOU_CHOICES) + 1)

# Hard example mining
NEGS_PER_POSITIVE = 3

BATCH_NORM_DECAY = 0.997
BATCH_NORM_EPSILON = 1e-4

# MLPerf reference LR schedule (base batch 32)
LEARNING_RATE_SCHEDULE = (
    (0, 1e-3),
    (160000, 1e-4),
    (200000, 1e-5),
)
MOMENTUM = 0.9
WEIGHT_DECAY = 5e-4

CHECKPOINT_FREQUENCY = 20000
MAX_NUM_EVAL_BOXES = 200
OVERLAP_CRITERIA = 0.5  # NMS IoU threshold
MIN_SCORE = 0.05
DUMMY_SCORE = -1e5

ANNOTATION_FILE = "annotations/instances_val2017.json"
COCO_NUM_VAL_IMAGES = 4952
