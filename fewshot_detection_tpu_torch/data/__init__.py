from .datasets import DetectionDataset, MetaDataset, get_labpath, get_labpath_1c
from .lists import is_dict, parse_dict_file

__all__ = [
    "DetectionDataset",
    "MetaDataset",
    "get_labpath",
    "get_labpath_1c",
    "is_dict",
    "parse_dict_file",
]
