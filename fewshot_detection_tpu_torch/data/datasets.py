"""Detection + support (meta) datasets.

Own copy of the JAX package's `data/datasets.py` (numpy/PIL code, no JAX),
native C++ loader paths included (`FSD_NATIVE=1`, `FSD_NATIVE_BATCH=1`).
Pure-python samplers feeding the train/eval steps; no torch DataLoader.
Reference behavior being reproduced (file:line in the reference):
  * listDataset — base-class filtering, multi-scale schedule keyed to the
    `seen` counter (dataset.py:223-245), label-path derivation
    (dataset.py:265-271)
  * MetaDataset — per-class support sampling interleaved so each contiguous
    n_cls block holds one sample per class (dataset.py:311-348), 4-channel
    (RGB+mask) input synthesis from one labeled box (dataset.py:378-403),
    resampling when a box yields an empty mask (dataset.py:423-445),
    ensemble enumeration dropping images whose boxes give empty masks
    (dataset.py:333-368, 447-457), per-class labels_1c paths
    (dataset.py:472-488)

The same `random.Random` stream is consumed in the same order as in the JAX
package, so one seed gives the same episodes, on the PIL path and on the
native one. PIL is imported where the PIL path opens an image file; the
native path needs no PIL, and a native library that cannot be built raises
rather than falling back to PIL.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from ..config.settings import Settings
from ..utils.imaging import get_image_size
from .augment import (
    augment_image,
    fill_truth_detection,
    fill_truth_detection_meta,
    image_to_array,
    load_label_boxes,
    sample_augment_params,
)

JITTER = 0.2
HUE = 0.1
SATURATION = 1.5
EXPOSURE = 1.5


def _native_pipe():
    """The native C++ loader under FSD_NATIVE=1, else None. A library that
    cannot be built raises (RuntimeError with the compiler's output)."""
    if os.environ.get("FSD_NATIVE", "0") != "1":
        return None
    from ..native import NativeImagePipe

    return NativeImagePipe()


class DecodedCache:
    """Decoded-image RAM cache: path -> (H, W, 3) uint8, fill-to-budget.

    The reference containers assumed torch num_workers could hide decode
    cost (train_meta.py:173-183); on a host with few cores re-decoding the
    same images through libjpeg/libpng every epoch dominates training. Most
    train sets fit in RAM decoded, so pay the decode once and run only the
    augment tail per epoch. No eviction: entries land until the byte budget
    (FSD_RAM_CACHE_MB, default 4096) is full, then misses decode from disk
    as before. Disable with FSD_RAM_CACHE=0.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self.bytes = 0
        self.map: dict[str, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def get(self, path: str, native=None) -> np.ndarray | None:
        """Cached decode (through `native` when given, else PIL); None when
        over budget (caller decodes from disk)."""
        arr = self.map.get(path)
        if arr is not None:
            self.hits += 1
            return arr
        if self.bytes >= self.max_bytes:
            self.misses += 1
            return None
        try:
            if native is not None:
                arr = native.decode(path)
            else:
                from PIL import Image

                with Image.open(path) as im:
                    arr = np.asarray(im.convert("RGB"), np.uint8)
        except Exception:
            self.misses += 1
            return None
        self.map[path] = arr
        self.bytes += arr.nbytes
        self.misses += 1
        return arr


_ram_cache: DecodedCache | None = None
_ram_cache_init = False


def ram_cache() -> DecodedCache | None:
    """Process-wide decoded-image cache (FSD_RAM_CACHE=1, the default)."""
    global _ram_cache, _ram_cache_init
    if not _ram_cache_init:
        _ram_cache_init = True
        if os.environ.get("FSD_RAM_CACHE", "1") == "1":
            mb = int(os.environ.get("FSD_RAM_CACHE_MB", "4096"))
            _ram_cache = DecodedCache(mb * (1 << 20))
    return _ram_cache


def reset_ram_cache() -> None:
    """Drop the process-wide cache; the next use builds it anew from the
    environment (for a caller that runs several stages in one process)."""
    global _ram_cache, _ram_cache_init
    _ram_cache, _ram_cache_init = None, False


def topath(p: str) -> str:
    """Dataset-root remapping hook (the reference hardcoded a cluster
    rewrite, dataset.py:17-18). Configure with FSD_PATH_MAP="old=new[,o=n]".
    """
    spec = os.environ.get("FSD_PATH_MAP", "")
    for rule in spec.split(","):
        if "=" in rule:
            old, new = rule.split("=", 1)
            p = p.replace(old, new)
    return p


def get_labpath(imgpath: str) -> str:
    return (
        imgpath.replace("images", "labels")
        .replace("JPEGImages", "labels")
        .replace(".jpg", ".txt")
        .replace(".png", ".txt")
    )


def get_labpath_1c(imgpath: str, cls_name: str, data: str = "voc") -> str:
    """Per-class label path under labels_1c/<class>/ (dataset.py:472-488)."""
    if data == "voc":
        return (
            imgpath.replace("images", f"labels_1c/{cls_name}")
            .replace("JPEGImages", f"labels_1c/{cls_name}")
            .replace(".jpg", ".txt")
            .replace(".png", ".txt")
        )
    if "train2014" in imgpath:
        return imgpath.replace(
            "images/train2014", f"labels_1c/train2014/{cls_name}"
        ).replace(".jpg", ".txt").replace(".png", ".txt")
    if "val2014" in imgpath:
        return imgpath.replace(
            "images/val2014", f"labels_1c/val2014/{cls_name}"
        ).replace(".jpg", ".txt").replace(".png", ".txt")
    raise ValueError(f"cannot derive labels_1c path for {imgpath!r}")


def _open_rgb(imgpath: str):
    """The decoded image as a PIL RGB image, from the RAM cache when it
    holds (or can take) it."""
    from PIL import Image

    cache = ram_cache()
    raw = cache.get(imgpath) if cache is not None else None
    if raw is not None:
        return Image.fromarray(raw)
    return Image.open(imgpath).convert("RGB")


def _native_params(native, imgpath: str, raw, rng: _random.Random):
    """Augmentation parameters for one image, drawn from `rng` as the PIL
    path draws them; the original size comes from the cached decode or the
    file's header."""
    if raw is not None:
        oh, ow = raw.shape[:2]
    else:
        ow, oh = native.image_size(imgpath)
    return sample_augment_params(
        ow, oh, rng, jitter=JITTER, hue=HUE, saturation=SATURATION, exposure=EXPOSURE,
    )


def _native_load(native, imgpath: str, shape, rng: _random.Random, augment: bool):
    """One image decoded, augmented and resized to `shape` through the C++
    pipeline: (float array, augmentation parameters or None). RAM-cache hits
    skip the decode and run only the raw augment tail."""
    cache = ram_cache()
    raw = cache.get(imgpath, native) if cache is not None else None
    if not augment:
        if raw is not None:
            return native.resize_raw(raw, shape[0], shape[1]), None
        return native.load_plain(imgpath, shape[0], shape[1]), None
    p = _native_params(native, imgpath, raw, rng)
    args = (shape[0], shape[1], p.pleft, p.pright, p.ptop, p.pbot, p.flip,
            p.dhue, p.dsat, p.dexp)
    if raw is not None:
        return native.augment_raw(raw, *args), p
    return native.load_augment(imgpath, *args), p


def multiscale_size(seen: int, rng: _random.Random, multiscale: bool) -> int:
    """Pick the square input size for the next 64-sample block
    (dataset.py:223-245): fixed 416 early, widening range with progress."""
    if not multiscale:
        return 416
    block = 4000 * 64
    if seen < block:
        return 13 * 32
    if seen < 2 * block:
        return (rng.randint(0, 3) + 13) * 32
    if seen < 3 * block:
        return (rng.randint(0, 5) + 12) * 32
    if seen < 4 * block:
        return (rng.randint(0, 7) + 11) * 32
    return (rng.randint(0, 9) + 10) * 32


def _noaug(kind: str) -> bool:
    """FSD_NOAUG=det|meta|all disables train-time augmentation for the
    detection/query stream, the support stream, or both (plain resize, no
    jitter/flip/HSV). Debug/ablation extension — the reference always
    augments in train mode (image.py:52-87, dataset.py:418-421)."""
    v = os.environ.get("FSD_NOAUG", "")
    return v == "all" or v == kind


class DetectionDataset:
    """Detection-image sampler (listDataset equivalent).

    Yields (image HWC float32 [0,1], label) where label is (50*5,) flat for
    plain training or (n_cls, 50*5) for meta training.
    """

    def __init__(
        self,
        lines: list[str] | str,
        settings: Settings,
        *,
        shape: tuple[int, int] | None = None,
        shuffle: bool = True,
        train: bool = False,
        seen: int = 0,
        filter_valid: bool | None = None,
        rng: _random.Random | None = None,
    ):
        from .lists import image_is_valid, is_dict

        self.settings = settings
        self.rng = rng or _random.Random()
        if isinstance(lines, str):
            if is_dict(lines):
                rows: list[str] = []
                with open(lines) as f:
                    files = [ln.rstrip().split()[-1] for ln in f if ln.strip()]
                for fname in files:
                    with open(topath(fname)) as f:
                        rows.extend(f.readlines())
                lines = sorted(set(rows))
            else:
                with open(lines) as f:
                    lines = f.readlines()
            if filter_valid is None:
                filter_valid = train
            # remap only at the raw-read boundary: python lists arriving
            # here (e.g. from load_lines/build_dataset) are already remapped
            lines = [topath(l) for l in lines]
        self.lines = [l.rstrip() for l in lines if l.strip()]
        if filter_valid:
            self.lines = [
                l for l in self.lines if image_is_valid(l, settings.base_ids)
            ]
        if shuffle:
            self.rng.shuffle(self.lines)
        self.train = train
        self.augment = train and not _noaug("det")
        self.shape = shape or (settings.width, settings.height)
        self.seen = seen
        self._native = _native_pipe()
        self._native_init = True
        # scale switches must land on batch boundaries; batches() sets this
        # to the actual batch size (the reference hardcoded its 64)
        self._rescale_every = 64

    @property
    def native(self):
        # lazily (re)constructed so the dataset survives pickling into
        # multi-process loader workers (the ctypes handle does not)
        if not self._native_init:
            self._native = _native_pipe()
            self._native_init = True
        return self._native

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = None
        state["_native_init"] = False
        return state

    def __len__(self) -> int:
        return len(self.lines)

    def image_size(self, index: int) -> tuple[int, int]:
        """(width, height) of the original image behind `lines[index]`."""
        return get_image_size(self.lines[index])

    def _maybe_rescale(self, index: int) -> None:
        s = self.settings
        if (
            self.train
            and index % self._rescale_every == 0
            and s.data != "coco"
            and s.multiscale
        ):
            size = multiscale_size(self.seen, self.rng, s.multiscale)
            self.shape = (size, size)

    def __getitem__(self, index: int):
        imgpath = self.lines[index]
        self._maybe_rescale(index)
        if self.native is not None:
            arr, flip, dx, dy, sx, sy = self._load_native(imgpath)
        else:
            img, flip, dx, dy, sx, sy = augment_image(
                _open_rgb(imgpath), self.shape, self.rng,
                jitter=JITTER, hue=HUE, saturation=SATURATION,
                exposure=EXPOSURE, augment=self.augment,
            )
            arr = image_to_array(img)
        label = self._label(imgpath, flip, dx, dy, sx, sy)
        self.seen += 1
        return arr, label

    def _load_native(self, imgpath: str):
        """Decode+augment through the C++ pipeline; randomness drawn from
        the same python stream as the PIL path."""
        arr, p = _native_load(self.native, imgpath, self.shape, self.rng, self.augment)
        if p is None:
            return arr, 0, 0.0, 0.0, 1.0, 1.0
        return arr, p.flip, p.dx, p.dy, p.sx, p.sy

    def _label(self, imgpath: str, flip, dx, dy, sx, sy):
        """The image's label under the geometry of its augmentation."""
        s = self.settings
        labpath = get_labpath(imgpath)
        if s.metayolo:
            return fill_truth_detection_meta(
                labpath, flip, dx, dy, 1.0 / sx, 1.0 / sy, s.base_ids
            )
        imgid = os.path.basename(imgpath).split(".")[0]
        joint = s.yolo_joint and imgid in s.metaids
        return fill_truth_detection(
            labpath, flip, dx, dy, 1.0 / sx, 1.0 / sy, s.base_ids,
            joint_keep=joint,
        )

    def batches(self, batch_size: int, drop_last: bool = True,
                offset: int = 0, stride: int = 1):
        """Yield stacked (images (B,H,W,3), labels) numpy batches. All images
        in a batch share one scale: the multiscale schedule only switches at
        batch boundaries.

        `offset`/`stride` partition batches across multi-process loader
        workers (worker w of W yields batches w, w+W, ...) — the reference's
        torch num_workers semantics (train_meta.py:173-183). `seen` (and so
        the multiscale width range) is pinned to the batch index so every
        worker sees the sequential schedule.

        FSD_NATIVE_BATCH=1 (with FSD_NATIVE=1) decodes each batch through
        the C++ pipeline's pthread batch API instead of per-image calls —
        identical outputs, scales with host cores."""
        # the smallest multiple of the batch size >= the reference's
        # 64-sample block
        self._rescale_every = ((64 + batch_size - 1) // batch_size) * batch_size
        n = len(self.lines)
        end = n - (n % batch_size) if drop_last else n
        seen0 = self.seen
        use_native_batch = (
            os.environ.get("FSD_NATIVE_BATCH", "0") == "1"
            and self.native is not None
        )
        for start in range(offset * batch_size, end, stride * batch_size):
            if stride > 1:
                self.seen = seen0 + start
            stop = min(start + batch_size, n)
            if use_native_batch:
                yield self._native_batch(start, stop)
                continue
            imgs, labels = [], []
            for i in range(start, stop):
                im, lb = self[i]
                imgs.append(im)
                labels.append(lb)
            yield np.stack(imgs), np.stack(labels)

    def _native_batch(self, start: int, stop: int):
        """One batch through the native pthread batch API: augmentation
        parameters are drawn per image from the SAME python rng stream as
        the per-image path (so outputs are identical), then all decodes +
        augments run threaded in C++. Raises IOError when an image fails to
        decode."""
        cache = ram_cache()
        paths, metas, raws = [], [], []
        for i in range(start, stop):
            imgpath = self.lines[i]
            self._maybe_rescale(i)
            raw = cache.get(imgpath, self.native) if cache is not None else None
            paths.append(imgpath)
            metas.append(_native_params(self.native, imgpath, raw, self.rng)
                         if self.augment else None)
            raws.append(raw)
            self.seen += 1
        if self.augment:
            params = np.asarray(
                [[p.pleft, p.pright, p.ptop, p.pbot, p.flip,
                  p.dhue, p.dsat, p.dexp] for p in metas], np.float32,
            )
        else:
            params = None
        if all(r is not None for r in raws):
            # every image cached: augment-only batch, zero disk IO
            batch, fails = self.native.load_batch_raw(
                raws, self.shape[0], self.shape[1], params
            )
        else:
            batch, fails = self.native.load_batch(
                paths, self.shape[0], self.shape[1], params
            )
        if fails:
            raise IOError(f"native batch decode failed for {fails} images")
        labels = [
            self._label(imgpath, p.flip, p.dx, p.dy, p.sx, p.sy) if p
            else self._label(imgpath, 0, 0.0, 0.0, 1.0, 1.0)
            for imgpath, p in zip(paths, metas)
        ]
        return batch, np.stack(labels)


class MetaDataset:
    """Per-class support sampler.

    train mode: an endless interleaved stream — each consecutive block of
    n_cls samples holds one (RGB, mask) support pair per class, in class
    order (so a contiguous per-device shard is a full class set,
    dataset.py:339-348).
    ensemble mode: enumerates ALL support images once, after a filter()
    prepass dropping images whose boxes give empty masks.
    """

    def __init__(
        self,
        metafiles: str,
        settings: Settings,
        *,
        train: bool = False,
        ensemble: bool = False,
        with_ids: bool = False,
        num_replicas: int | None = None,
        rng: _random.Random | None = None,
    ):
        from .lists import parse_dict_file

        self.settings = settings
        self.rng = rng or _random.Random()
        s = settings
        if train:
            self.classes = s.base_classes
            factor = 4 if s.data == "coco" else 1
        else:
            self.classes = s.base_classes if s.data == "coco" else s.classes
            factor = 10

        num_replicas = num_replicas or s.num_gpus
        nbatch = factor * 500 * 64 * num_replicas // s.batch_size

        files = dict(parse_dict_file(metafiles))
        self.metalines: list[list[str]] = []
        metainds: list[list[tuple[int, int]]] = []
        for i, cls in enumerate(self.classes):
            with open(topath(files[cls])) as f:
                lines = [topath(l.rstrip()) for l in f if l.strip()]
            self.metalines.append(lines)
            if ensemble:
                metainds.append([(i, j) for j in range(len(lines))])
            else:
                inds = [self.rng.randrange(len(lines)) for _ in range(nbatch)]
                metainds.append([(i, j) for j in inds])

        if ensemble:
            self.inds = [p for cls_list in metainds for p in cls_list]
        else:
            # interleave: class-major within each block of n_cls
            self.inds = [p for group in zip(*metainds) for p in group]
        self.meta_cnts = [len(l) for l in self.metalines]
        if s.randmeta:
            self.rng.shuffle(self.inds)

        self.train = train
        self.augment = train and not _noaug("meta")
        self.ensemble = ensemble
        self.with_ids = with_ids
        self.batch_size = len(self.classes) * num_replicas
        self.meta_shape = (s.meta_width, s.meta_height)
        self.mask_shape = (s.mask_width, s.mask_height)
        # native decode+augment applies to plain RGB support inputs; the
        # metain 3/4 cropped-object channels need the PIL image around
        self.native = _native_pipe() if s.metain_type in (1, 2) else None
        # ensemble filtering is LAZY: the reference ran a full filter()
        # decode prepass and then decoded every kept image AGAIN during the
        # sweep (dataset.py:447-457). batches() streams with on-the-fly
        # validity instead (one decode per image); the eager prepass only
        # happens if someone indexes/len()s the dataset.
        self._needs_filter = ensemble

    def _ensure_filtered(self) -> None:
        if self._needs_filter:
            self.inds = self._filter(self.inds)
            self._needs_filter = False

    def __len__(self) -> int:
        self._ensure_filtered()
        return len(self.inds)

    # -- internals ---------------------------------------------------------

    def _load_support(self, clsid: int, which: int | str):
        """One augmented support image + its transformed per-class boxes.
        Returns (PIL image | float array, boxes)."""
        if isinstance(which, int):
            imgpath = self.metalines[clsid][which].rstrip()
        else:
            imgpath = which
        labpath = get_labpath_1c(
            imgpath, self.classes[clsid], self.settings.data
        )
        if self.native is not None:
            arr, p = _native_load(self.native, imgpath, self.meta_shape, self.rng,
                                  self.augment)
            if p is None:
                return arr, load_label_boxes(labpath, 0, 0, 0, 1.0, 1.0)
            return arr, load_label_boxes(labpath, p.flip, p.dx, p.dy, 1.0 / p.sx, 1.0 / p.sy)
        img, flip, dx, dy, sx, sy = augment_image(
            _open_rgb(imgpath), self.meta_shape, self.rng,
            jitter=JITTER, hue=HUE, saturation=SATURATION, exposure=EXPOSURE,
            augment=self.augment,
        )
        boxes = load_label_boxes(labpath, flip, dx, dy, 1.0 / sx, 1.0 / sy)
        return img, boxes

    def _make_mask(self, box: np.ndarray) -> np.ndarray | None:
        """Binary object mask (H, W, 1) from one normalized box
        (dataset.py:378-398); None when it rounds to empty."""
        w, h = self.mask_shape
        x1 = int(max(0, round((box[0] - box[2] / 2) * w)))
        y1 = int(max(0, round((box[1] - box[3] / 2) * h)))
        x2 = int(min(w, round((box[0] + box[2] / 2) * w)))
        y2 = int(min(h, round((box[1] + box[3] / 2) * h)))
        if x1 == x2 or y1 == y2:
            return None
        mask = np.zeros((h, w, 1), np.float32)
        mask[y1:y2, x1:x2, :] = 1.0
        return mask

    def _compose_input(self, img, box: np.ndarray):
        """(image array, mask) per metain_type; type 3/4 appends the cropped
        object resized to full size (dataset.py:386-391). `img` is a float
        array when the native loader produced it, else a PIL image."""
        s = self.settings
        mask = self._make_mask(box)
        if mask is None:
            return None, None
        arr = img if isinstance(img, np.ndarray) else image_to_array(img)
        if s.metain_type in (3, 4):
            w, h = self.mask_shape
            x1 = int(max(0, round((box[0] - box[2] / 2) * w)))
            y1 = int(max(0, round((box[1] - box[3] / 2) * h)))
            x2 = int(min(w, round((box[0] + box[2] / 2) * w)))
            y2 = int(min(h, round((box[1] + box[3] / 2) * h)))
            croped = img.crop((x1, y1, x2, y2)).resize(img.size)
            arr = np.concatenate([arr, image_to_array(croped)], axis=-1)
        return arr, mask

    def _get(self, clsid: int, metaind: int | str):
        img, boxes = self._load_support(clsid, metaind)
        for box in boxes:
            arr, mask = self._compose_input(img, box)
            if arr is not None:
                return arr, mask
        # resample until a usable mask appears (never during ensemble)
        while not self.ensemble:
            imgpath = self.rng.sample(self.metalines[clsid], 1)[0].rstrip()
            img, boxes = self._load_support(clsid, imgpath)
            for box in boxes:
                arr, mask = self._compose_input(img, box)
                if arr is not None:
                    return arr, mask
        return None, None

    def _filter(self, inds):
        kept = []
        for clsid, metaind in inds:
            arr, mask = self._get(clsid, metaind)
            if arr is not None:
                kept.append((clsid, metaind))
        return kept

    # -- public ------------------------------------------------------------

    def __getitem__(self, index: int):
        self._ensure_filtered()
        clsid, metaind = self.inds[index]
        arr, mask = self._get(clsid, metaind)
        if self.with_ids:
            return arr, mask, clsid
        return arr, mask

    def batches(self, batch_size: int | None = None):
        """Yield stacked (metax (B,H,W,C), mask (B,h,w,1)[, clsids])."""
        bs = batch_size or self.batch_size
        if self.ensemble and self._needs_filter:
            # single-decode stream: validity decided as images are loaded,
            # exactly the set the eager filter()+re-decode would keep
            chunk = []
            for clsid, metaind in self.inds:
                arr, mask = self._get(clsid, metaind)
                if arr is None:
                    continue
                chunk.append((arr, mask, clsid))
                if len(chunk) == bs:
                    yield self._stack(chunk)
                    chunk = []
            if chunk:
                yield self._stack(chunk)
            return
        for start in range(0, len(self.inds) - (0 if self.ensemble else bs - 1),
                           bs):
            chunk = [self[i] for i in range(start, min(start + bs, len(self.inds)))]
            arrs = np.stack([c[0] for c in chunk])
            masks = np.stack([c[1] for c in chunk])
            if self.with_ids:
                yield arrs, masks, np.asarray([c[2] for c in chunk])
            else:
                yield arrs, masks

    def _stack(self, chunk):
        arrs = np.stack([c[0] for c in chunk])
        masks = np.stack([c[1] for c in chunk])
        if self.with_ids:
            return arrs, masks, np.asarray([c[2] for c in chunk])
        return arrs, masks
