"""Immutable run settings resolved from `.data` / `.cfg` options.

The reference kept a process-global mutable EasyDict (`cfg` in
reference cfg.py:7-195) that every module read ambiently. Here the
same resolution logic — class universe, base/novel split, tuning policy,
save-interval scaling, meta-input channel math, backup-dir name mangling —
produces one frozen dataclass that is threaded explicitly through the
framework.

Parity citations (reference file:line):
  * class universes & split resolution  cfg.py:19-26, 55-63, 103-118
  * tuning / repeat / save_interval     cfg.py:84-101
  * neg-ratio parsing                   cfg.py:121-128
  * backup dir naming                   cfg.py:130-147
  * meta-input channel math             cfg.py:155-190
  * yolo_joint metaids                  cfg.py:41-53, 143-147
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping

VOC_CLASSES: tuple[str, ...] = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow", "diningtable",
    "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)

# Maximum number of ground-truth boxes per (image[, class]) — cfg.py:29
MAX_BOXES = 50


def _data_asset(relpath: str) -> str:
    """Resolve a data asset: cwd-relative first, then repo-root fallback."""
    if os.path.exists(relpath):
        return relpath
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cand = os.path.join(root, relpath)
    return cand if os.path.exists(cand) else relpath


def load_class_names(name: str = "voc") -> tuple[str, ...]:
    path = _data_asset(f"data/{name}.names")
    with open(path) as f:
        return tuple(line.strip() for line in f if line.strip())


def get_novels(root: str, novelid: str | None = None) -> tuple[str, ...]:
    """Resolve the novel-class list: a line of `voc_novels.txt` or a literal
    comma-separated class list (cfg.py:55-63)."""
    if root.endswith("txt"):
        if novelid == "None" or novelid is None:
            return ()
        with open(_data_asset(root)) as f:
            lines = f.readlines()
        return tuple(lines[int(novelid)].strip().split(","))
    return tuple(root.split(","))


def _get_meta_image_ids(metafile: str, base_classes: tuple[str, ...]) -> tuple[str, ...]:
    """Image ids covered by a meta dict file, for yolo_joint (cfg.py:41-53)."""
    from ..data.datasets import topath
    from ..data.lists import parse_dict_file

    pairs = parse_dict_file(_data_asset(metafile))
    files = [path for cls, path in pairs if cls in base_classes]
    lines: list[str] = []
    for fname in files:
        with open(topath(fname)) as f:
            lines.extend(f.readlines())
    uniq = sorted(set(lines))
    return tuple(l.split("/")[-1].split(".")[0] for l in uniq)


def _add_backup(backup: str, addon: str) -> str:
    parts = backup.split("_")
    parts[0] += addon
    return "_".join(parts)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Frozen configuration for one training / evaluation run."""

    data: str = "voc"
    classes: tuple[str, ...] = VOC_CLASSES
    base_classes: tuple[str, ...] = VOC_CLASSES
    novel_classes: tuple[str, ...] = ()
    base_ids: tuple[int, ...] = tuple(range(20))
    novel_ids: tuple[int, ...] = ()
    real_base_ids: tuple[int, ...] = tuple(range(20))
    novelid: str = "None"

    max_boxes: int = MAX_BOXES
    # coord warm-up threshold: seen < warmup_seen trains every cell toward
    # the constant box prior (region_loss.py:70-79 hardcodes 12800). A
    # loss-semantics rule, so it lives here; FSD_WARMUP_SEEN overrides it at
    # configure() time for compressed synthetic schedules (PERF.md
    # "warm-up collapse").
    warmup_seen: int = 12800
    neg_ratio: float | str = "full"
    tuning: bool = False
    metayolo: bool = True
    repeat: int = 1
    save_interval: int = 10
    multiscale: bool = True
    metain_type: int = 2
    randmeta: bool = False
    shot: int = 0
    max_epoch: int = 0
    num_gpus: int = 1
    backup: str = "backup"
    yolo_joint: bool = False
    metaids: tuple[str, ...] = ()

    # [net] header
    width: int = 416
    height: int = 416
    batch_size: int = 64

    # [learnet] header
    meta_width: int = 416
    meta_height: int = 416
    mask_width: int = 416
    mask_height: int = 416
    meta_channels: int = 4
    feat_layer: int = 0

    @property
    def n_base(self) -> int:
        return len(self.base_classes)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @staticmethod
    def configure(
        data_options: Mapping[str, str],
        net_options: Mapping[str, str] | None = None,
        meta_options: Mapping[str, str] | None = None,
    ) -> "Settings":
        """Resolve Settings from parsed `.data` / `[net]` / `[learnet]` dicts.

        Replicates __configure_data / __configure_net / __configure_meta
        (cfg.py:70-190) as a pure function.
        """
        s: dict = {}
        # CLI override parsed at configure() time (startup), never at import
        env_warmup = os.environ.get("FSD_WARMUP_SEEN")
        if env_warmup is not None:
            s["warmup_seen"] = int(env_warmup)
        data = data_options.get("data", "voc")
        s["data"] = data
        if data == "voc":
            classes = VOC_CLASSES
        elif data == "coco":
            classes = load_class_names("coco")
            s["save_interval"] = 2
        else:
            raise NotImplementedError(f"data type {data!r} not supported")
        s["classes"] = classes

        if "scale" in data_options:
            s["multiscale"] = bool(int(data_options["scale"]))
        if "metain_type" in data_options:
            s["metain_type"] = int(data_options["metain_type"])

        tuning = bool(int(data_options.get("tuning", "0")))
        s["tuning"] = tuning
        if tuning:
            max_epoch = int(data_options.get("max_epoch", "500"))
            repeat = int(data_options.get("repeat", "100"))
            s["max_epoch"] = max_epoch
            s["repeat"] = repeat
            epochs = max_epoch / repeat
            if epochs <= 20:
                s["save_interval"] = 1
            elif epochs <= 50:
                s["save_interval"] = 2
            elif epochs <= 100:
                s["save_interval"] = 5
            else:
                s["save_interval"] = 10
            if data == "coco":
                s["save_interval"] = 2
            s["shot"] = int(
                data_options["meta"].split(".")[0].split("_")[-1].replace("shot", "")
            )

        novelid = data_options.get("novelid", "None")
        s["novelid"] = novelid
        novel_classes = get_novels(data_options.get("novel", "None"), novelid) \
            if "novel" in data_options else ()
        s["novel_classes"] = novel_classes
        if tuning:
            # during tuning ALL classes are trained (cfg.py:106-113)
            base_classes = classes
        else:
            base_classes = tuple(c for c in classes if c not in novel_classes)
        s["base_classes"] = base_classes
        s["base_ids"] = tuple(classes.index(c) for c in base_classes)
        novel_ids = tuple(classes.index(c) for c in novel_classes)
        s["novel_ids"] = novel_ids
        s["real_base_ids"] = tuple(
            i for i in range(len(classes)) if i not in novel_ids
        )

        s["num_gpus"] = len(data_options.get("gpus", "0").split(","))
        neg: float | str = data_options.get("neg", "full")
        if isinstance(neg, str) and neg.isdigit():
            negf = float(neg)
            neg = int(negf) if negf.is_integer() else negf
        s["neg_ratio"] = neg
        s["randmeta"] = bool(int(data_options.get("rand", "0")))
        s["metayolo"] = bool(int(data_options.get("metayolo", "1")))

        # Backup dir naming (cfg.py:130-147)
        backup = data_options.get("backup", "backup")
        if not s.get("multiscale", True):
            backup += "fix"
        if s.get("metain_type", 2) != 2:
            backup = _add_backup(backup, f"in{s['metain_type']}")
        backup += f"_novel{novelid}"
        if s["metayolo"]:
            backup += f"_neg{s['neg_ratio']}"
        if s["randmeta"]:
            backup += "_rand"

        yolo_joint = bool(int(data_options.get("joint", "0")))
        s["yolo_joint"] = yolo_joint
        if yolo_joint:
            s["metaids"] = _get_meta_image_ids(data_options["meta"], base_classes)
            shot = int(
                data_options["meta"].split(".")[0].split("_")[-1].replace("shot", "")
            )
            backup += f"_joint{shot}"
        s["backup"] = backup

        if net_options is not None:
            s["height"] = int(net_options["height"])
            s["width"] = int(net_options["width"])
            s["batch_size"] = int(net_options["batch"])

        if meta_options is not None:
            mh = int(meta_options["height"])
            mw = int(meta_options["width"])
            s["meta_height"] = mh
            s["meta_width"] = mw
            factor = int(meta_options.get("feat_layer", "0"))
            s["feat_layer"] = factor
            s["mask_height"] = mh if factor == 0 else mh // factor
            s["mask_width"] = mw if factor == 0 else mw // factor
            metain = s.get("metain_type", 2)
            # channel math (cfg.py:155-190)
            table = {0: {1: 3, 2: 4, 3: 7, 4: 6}, 4: {1: 64, 2: 65, 3: 129, 4: 128}}
            if factor not in table or metain not in table[factor]:
                raise NotImplementedError(
                    f"meta input type {metain} at feat_layer {factor} not supported"
                )
            s["meta_channels"] = table[factor][metain]

        return Settings(**s)
