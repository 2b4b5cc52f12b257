"""Inference-time detector wrapper: cfg + .weights -> forward on one device."""

from __future__ import annotations

import numpy as np
import torch

from ..config.darkcfg import parse_cfg
from ..models import meta as meta_mod
from ..models.convert import from_jax_params
from ..models.meta import MetaSpec, init_meta_params
from ..models.spec import build_spec
from ..models.weights_io import WeightsHeader, load_weights, load_weights_bf16_gz


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. `"cuda"` without a card raises:
    nothing moves to the CPU unless the caller asked for `"cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


class MetaDetector:
    """Meta detector (darknet_meta.Darknet equivalent): class-code
    extraction + dynamically reweighted detection forward.

    Parameters are loaded into the numpy tree, converted once and kept on
    `device`. BN is NOT folded: every conv runs conv -> batchnorm_apply in
    `compute_dtype`, as the JAX package's MetaDetector does, so bf16 results
    agree in kind. A `.weights.bf16.gz` artifact is read directly."""

    def __init__(
        self,
        darknetcfg: str | list,
        learnetcfg: str | list,
        weightfile: str | None = None,
        metain_type: int = 2,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        dblocks = darknetcfg if isinstance(darknetcfg, list) else parse_cfg(darknetcfg)
        lblocks = learnetcfg if isinstance(learnetcfg, list) else parse_cfg(learnetcfg)
        self.spec = MetaSpec(build_spec(dblocks), build_spec(lblocks))
        params = init_meta_params(self.spec, 0)
        self.header = WeightsHeader()
        if weightfile:
            load = load_weights_bf16_gz if weightfile.endswith(".bf16.gz") else load_weights
            (dp, lp), self.header = load(
                weightfile,
                [self.spec.darknet, self.spec.learnet],
                [params["darknet"], params["learnet"]],
            )
            params = {"darknet": dp, "learnet": lp}
        self.params = {
            "darknet": from_jax_params(self.spec.darknet, params["darknet"], self.device),
            "learnet": from_jax_params(self.spec.learnet, params["learnet"], self.device),
        }
        self.metain_type = metain_type
        self.region = self.spec.region
        self.width = self.spec.darknet.width
        self.height = self.spec.darknet.height
        self.compute_dtype = compute_dtype

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device, dtype)

    def commit_codes(self, codes) -> list[torch.Tensor]:
        """Put fixed class codes on the device once for a whole sweep, in
        float32; detect() then reuses them as they are."""
        return [self._to_device(c, torch.float32) for c in codes]

    @torch.no_grad()
    def class_codes(self, metax: np.ndarray, mask: np.ndarray) -> list[np.ndarray]:
        """Support batch -> list of per-class code tensors (N, 1, 1, C).
        Returned as float32 host arrays (they get averaged/spliced on host)."""
        out = meta_mod.meta_forward(
            self.spec, self.params,
            self._to_device(metax, self.compute_dtype),
            self._to_device(mask, self.compute_dtype),
            metain_type=self.metain_type,
        )
        return [d.float().cpu().numpy() for d in out]

    @torch.no_grad()
    def detect(self, images, dynamic_weights) -> torch.Tensor:
        """Raw head output (B*n_cls, H/32, W/32, A*(5+nC)) in float32, left
        on the device for the box decode. Rows are image-major."""
        x = self._to_device(images, self.compute_dtype)
        dw = [self._to_device(d, self.compute_dtype) for d in dynamic_weights]
        return meta_mod.detect_forward(self.spec, self.params, x, dw, fuse=True).float()

    def __call__(self, images, metax, mask) -> torch.Tensor:
        return self.detect(images, self.class_codes(metax, mask))
