from .voc_eval import voc_ap, voc_eval, do_python_eval
from .detector import MetaDetector, PlainDetector

__all__ = ["voc_ap", "voc_eval", "do_python_eval", "MetaDetector", "PlainDetector"]
