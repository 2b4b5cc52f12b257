"""Inference-time detector wrappers: cfg + .weights -> forward on one device."""

from __future__ import annotations

import numpy as np
import torch

from ..config.darkcfg import parse_cfg
from ..models import meta as meta_mod
from ..models.convert import from_jax_params
from ..models.darknet import apply_network, fold_batchnorm, folded_spec, init_params
from ..models.meta import MetaSpec, init_meta_params
from ..models.quant import (
    _is_quantizable,
    absmax_observer,
    apply_network_int8,
    calibrate_act_scales,
    quantize_weights,
    scales_from_absmax,
)
from ..models.spec import build_spec
from ..models.weights_io import WeightsHeader, load_weights, load_weights_bf16_gz
from ..utils.card import resolve_device


def _load_into(weightfile: str | None, specs, params):
    """Read a `.weights` (or `.weights.bf16.gz`) file into the numpy trees
    `params` (one per spec); (trees, header). No file: the trees as given."""
    if not weightfile:
        return params, WeightsHeader()
    load = load_weights_bf16_gz if weightfile.endswith(".bf16.gz") else load_weights
    return load(weightfile, specs, params)


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device, dtype)


class PlainDetector:
    """Static YOLOv2 network (darknet.Darknet equivalent).

    BN is folded into the conv weights once at load (`fold_batchnorm`), so
    the inference graph is conv+bias+leaky only, as in the JAX package's
    PlainDetector. `compute_dtype=torch.bfloat16` runs the conv stack in
    bfloat16 on the folded (then rounded) weights; float32 is the parity
    default. The output is float32 and stays on `device`."""

    def __init__(
        self,
        cfgfile: str,
        weightfile: str | None = None,
        compute_dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.spec = build_spec(parse_cfg(cfgfile))
        (params,), self.header = _load_into(weightfile, [self.spec], [init_params(self.spec, 0)])
        self.params = fold_batchnorm(self.spec, from_jax_params(self.spec, params, self.device))
        self.fspec = folded_spec(self.spec)
        self.region = self.spec.region
        self.width = self.spec.width
        self.height = self.spec.height
        self.compute_dtype = compute_dtype
        self.qparams = None
        self.act_scales = None

    def quantize_int8(self, calib_images: np.ndarray) -> None:
        """Switch serving to the int8 product (models/quant.py): per-channel
        int8 weights from the folded graph, per-tensor activation scales
        calibrated in float32 on `calib_images` (a representative
        (N, H, W, 3) [0,1] batch). Stem and head stay in the compute dtype."""
        self.qparams = quantize_weights(self.fspec, self.params)
        self.act_scales = calibrate_act_scales(
            self.fspec, self.params, np.asarray(calib_images, np.float32))

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) float32 [0,1] -> raw head output (B, H/32,
        W/32, A*(5+nC)) in float32, left on the device for the box decode;
        through the int8 graph once `quantize_int8` ran."""
        x = _to_device(images, self.device, self.compute_dtype)
        if self.qparams is not None:
            return apply_network_int8(self.fspec, self.qparams, self.act_scales, x).float()
        y, _ = apply_network(self.fspec, self.params, x, train=False)
        return y.float()


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
        init = init_meta_params(self.spec, 0)
        (dp, lp), self.header = _load_into(
            weightfile, [self.spec.darknet, self.spec.learnet],
            [init["darknet"], init["learnet"]],
        )
        self.params = {
            "darknet": from_jax_params(self.spec.darknet, dp, self.device),
            "learnet": from_jax_params(self.spec.learnet, lp, self.device),
        }
        self.metain_type = metain_type
        self.region = self.spec.region
        self.width = self.spec.darknet.width
        self.height = self.spec.darknet.height
        self.compute_dtype = compute_dtype
        # the int8 graphs, set by quantize_int8 (detect) and with
        # calib_support (class_codes)
        self.qspec = self.qparams = self.act_scales = None
        self.lqspec = self.lqparams = self.learnet_act_scales = None

    @torch.no_grad()
    def quantize_int8(self, calib_images: np.ndarray, dynamic_weights,
                      calib_support=None, quant_head: bool = False) -> None:
        """int8 serving for the meta path: fold BN into the backbone convs,
        quantize them per channel, calibrate activation scales on
        `calib_images` in the compute dtype. The class codes do not
        influence the activations before the reweighting, so any
        representative `dynamic_weights` serve for calibration.

        `calib_support=(metax, mask)` also quantizes the LEARNET (the
        ensemble sweep's phase 1 runs it over every support image);
        class_codes() then serves int8.

        `quant_head=True` also runs the fused reweight+head contraction as
        an int8 product (the effective per-class weights are quantized on
        the device at each call, since they depend on the sweep's codes)."""
        dfspec = folded_spec(self.spec.darknet)
        dfolded = fold_batchnorm(self.spec.darknet, self.params["darknet"])
        qspec = MetaSpec(dfspec, self.spec.learnet)
        dyn_idx = next(
            (l.index for l in dfspec.layers if l.kind == "conv" and l.dynamic), None)
        absmax: dict[int, float] = {}
        observe = absmax_observer(absmax, lambda idx: _is_quantizable(
            dfspec, dfspec.layers[idx]) or (quant_head and idx == dyn_idx))
        meta_mod.detect_forward(
            qspec, {"darknet": dfolded, "learnet": None},
            self._to_device(np.asarray(calib_images, np.float32), self.compute_dtype),
            [self._to_device(d, torch.float32) for d in dynamic_weights],
            fuse=True, observe=observe,
        )
        self.act_scales = scales_from_absmax(absmax)
        self.qparams = quantize_weights(dfspec, dfolded)
        self.qspec = qspec
        if calib_support is not None:
            self._quantize_learnet(calib_support)

    def _quantize_learnet(self, calib_support) -> None:
        """Fold and quantize the learnet convs per channel, calibrate their
        input scales on a support batch, and route class_codes() through
        the int8 graph."""
        lfspec = folded_spec(self.spec.learnet)
        lfolded = fold_batchnorm(self.spec.learnet, self.params["learnet"])
        # the (unquantized, folded) darknet serves the feat_layer stem
        dfolded = fold_batchnorm(self.spec.darknet, self.params["darknet"])
        lqspec = MetaSpec(folded_spec(self.spec.darknet), lfspec)
        absmax: dict[int, float] = {}
        observe = absmax_observer(
            absmax, lambda idx: _is_quantizable(lfspec, lfspec.layers[idx]))
        metax, mask = calib_support
        meta_mod.meta_forward(
            lqspec, {"darknet": dfolded, "learnet": lfolded},
            self._to_device(np.asarray(metax, np.float32), self.compute_dtype),
            self._to_device(np.asarray(mask, np.float32), self.compute_dtype),
            metain_type=self.metain_type, observe=observe,
        )
        self.learnet_act_scales = scales_from_absmax(absmax)
        self.lqparams = {"darknet": dfolded, "learnet": quantize_weights(lfspec, lfolded)}
        self.lqspec = lqspec

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return _to_device(a, self.device, dtype)

    def commit_codes(self, codes) -> list[torch.Tensor]:
        """Put fixed class codes on the device once for a whole sweep, in
        float32; detect() then reuses them as they are."""
        return [self._to_device(c, torch.float32) for c in codes]

    @torch.no_grad()
    def class_codes(self, metax: np.ndarray, mask: np.ndarray) -> list[np.ndarray]:
        """Support batch -> list of per-class code tensors (N, 1, 1, C).
        Returned as float32 host arrays (they get averaged/spliced on host)."""
        spec, params = self.spec, self.params
        if self.lqparams is not None:
            spec, params = self.lqspec, self.lqparams
        out, _ = meta_mod.meta_forward(
            spec, params,
            self._to_device(metax, self.compute_dtype),
            self._to_device(mask, self.compute_dtype),
            metain_type=self.metain_type, act_scales=self.learnet_act_scales,
        )
        return [d.float().cpu().numpy() for d in out]

    @torch.no_grad()
    def detect(self, images, dynamic_weights) -> torch.Tensor:
        """Raw head output (B*n_cls, H/32, W/32, A*(5+nC)) in float32, left
        on the device for the box decode. Rows are image-major."""
        x = self._to_device(images, self.compute_dtype)
        dw = [self._to_device(d, self.compute_dtype) for d in dynamic_weights]
        if self.qparams is not None:
            y, _ = meta_mod.detect_forward(
                self.qspec, {"darknet": self.qparams, "learnet": None}, x, dw,
                fuse=True, act_scales=self.act_scales)
        else:
            y, _ = meta_mod.detect_forward(self.spec, self.params, x, dw, fuse=True)
        return y.float()

    def __call__(self, images, metax, mask) -> torch.Tensor:
        return self.detect(images, self.class_codes(metax, mask))
