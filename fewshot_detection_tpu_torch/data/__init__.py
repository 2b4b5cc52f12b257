from .augment import (
    augment_image,
    distort_hsv,
    fill_truth_detection,
    fill_truth_detection_meta,
    load_label_boxes,
)
from .datasets import DetectionDataset, MetaDataset, get_labpath, get_labpath_1c
from .lists import build_dataset, build_fewset, is_dict, load_lines, load_metadict

__all__ = [
    "augment_image",
    "distort_hsv",
    "fill_truth_detection",
    "fill_truth_detection_meta",
    "load_label_boxes",
    "DetectionDataset",
    "MetaDataset",
    "get_labpath",
    "get_labpath_1c",
    "build_dataset",
    "build_fewset",
    "is_dict",
    "load_lines",
    "load_metadict",
]
