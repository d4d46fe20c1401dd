"""Dataset label conventions (counterpart: segtpu/data/label_maps.py).

* CityScapes: raw labelIds (0..33) -> 19 train ids, everything else 255.
* CamVid: the standard 11-class protocol (+255 void).
* VOC: masks are already 0..20 with 255 boundary — identity.
"""

from __future__ import annotations

import numpy as np

from segtpu_torch.utils.metrics import IGNORE_LABEL

# CityScapes labelId -> trainId (the canonical mapping of
# cityscapesScripts' labels.py; 19 evaluated classes)
_CITYSCAPES_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

CITYSCAPES_NUM_CLASSES = 19
CAMVID_NUM_CLASSES = 11
VOC_NUM_CLASSES = 21

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle")

CAMVID_CLASSES = (
    "sky", "building", "pole", "road", "pavement", "tree", "sign symbol",
    "fence", "car", "pedestrian", "bicyclist")


def _lut(mapping: dict) -> np.ndarray:
    lut = np.full(256, IGNORE_LABEL, np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    return lut


_CITYSCAPES_LUT = _lut(_CITYSCAPES_ID_TO_TRAIN)
# CamVid masks in the common release are already 0..10 with 11 = void
_CAMVID_LUT = _lut({i: i for i in range(CAMVID_NUM_CLASSES)})


def cityscapes_to_train_ids(mask: np.ndarray) -> np.ndarray:
    """Raw labelId mask -> 19-class trainId mask (255 = ignore)."""
    return _CITYSCAPES_LUT[mask]


def camvid_to_train_ids(mask: np.ndarray) -> np.ndarray:
    return _CAMVID_LUT[mask]


LABEL_MAPS = {
    "cityscapes": cityscapes_to_train_ids,
    "camvid": camvid_to_train_ids,
    "voc": lambda m: m,
    None: lambda m: m,
}

NUM_CLASSES = {
    "cityscapes": CITYSCAPES_NUM_CLASSES,
    "camvid": CAMVID_NUM_CLASSES,
    "voc": VOC_NUM_CLASSES,
}
