"""Support-code signal-to-noise diagnostic for episodic training.

Streams real augmented support batches through the learnet (the exact
MetaDataset train path: jitter/flip/HSV, mask synthesis — dataset.py:418-421
semantics) and measures whether the per-class dynamic-weight codes carry a
class signal at all:

  * within-class distance: mean ||code(draw, c) - mean_draws(code(c))||
  * across-class distance: mean ||mean_draws(code(c)) - grand mean||
  * 1-NN accuracy: held-out draw's code matched to the nearest other-draws
    class mean (chance = 1/n_cls)

If across/within is well below 1 and 1-NN is near chance, the support codes
are episode noise — the cross-copy classification gradient
(region_loss.py:303-335 semantics) has no consistent signal to follow and
streaming cls pins at ln(n_cls) regardless of LR or schedule. This is a
property of the DATASET (e.g. synthetic classes whose discriminative
feature is randomized per instance), not of the model: it separated "task
unlearnable" from "pipeline bug" in the round-3 investigation (PERF.md
"Streaming episodic learning").

Usage:
  python scripts/support_snr_torch.py datacfg darknetcfg learnetcfg [weights] [--device DEVICE]
"""

# The counterpart of scripts/support_snr.py on the PyTorch port: the same
# arguments, statistics, rounding and JSON line, and a --device (default
# cuda; the JAX script pins the CPU). The learnet runs in float32 with TF32
# off, in training mode, so every BatchNorm takes its batch statistics
# through the bn_sums kernel.

import json
import random
import sys

import numpy as np

REPO = __file__.rsplit("/", 2)[0]
sys.path.insert(0, REPO)


def draw_codes(datacfg, darknetcfg, learnetcfg, weightfile=None, n_draws=6,
               seed=99, device="cuda"):
    """(n_draws, n_cls, dim) float32 numpy: each draw's per-class codes, the
    learnet's code tensors flattened and concatenated in order."""
    import torch

    from fewshot_detection_tpu_torch.cli.common import resolve_configs
    from fewshot_detection_tpu_torch.data import MetaDataset
    from fewshot_detection_tpu_torch.eval.detector import resolve_device
    from fewshot_detection_tpu_torch.eval.valid import set_float32_precision
    from fewshot_detection_tpu_torch.models import weights_io
    from fewshot_detection_tpu_torch.models.convert import from_jax_params
    from fewshot_detection_tpu_torch.models.meta import (
        MetaSpec, init_meta_params, meta_forward)
    from fewshot_detection_tpu_torch.models.spec import build_spec

    dev = resolve_device(device)
    set_float32_precision(tf32=False)
    data_options, dk, ln, settings = resolve_configs(
        datacfg, darknetcfg, learnetcfg)
    spec = MetaSpec(build_spec(dk), build_spec(ln))
    params = init_meta_params(spec, 0)
    if weightfile:
        (dp, lp), _ = weights_io.load_weights(
            weightfile, [spec.darknet, spec.learnet],
            [params["darknet"], params["learnet"]])
        params = {"darknet": dp, "learnet": lp}
    params = {"darknet": from_jax_params(spec.darknet, params["darknet"], dev),
              "learnet": from_jax_params(spec.learnet, params["learnet"], dev)}

    metaset = MetaDataset(data_options["meta"], settings, train=True,
                          num_replicas=1, rng=random.Random(seed))
    n_cls = len(metaset.classes)
    mit = metaset.batches(n_cls)
    draws = []
    with torch.no_grad():
        for _ in range(n_draws):
            metax, mask = next(mit)
            dw, _ = meta_forward(spec, params,
                                 torch.as_tensor(metax, dtype=torch.float32, device=dev),
                                 torch.as_tensor(mask, dtype=torch.float32, device=dev),
                                 metain_type=settings.metain_type, train=True)
            draws.append(np.concatenate(
                [w.float().reshape(n_cls, -1).cpu().numpy() for w in dw], axis=1))
    return np.stack(draws)


def summarize(C):
    """The statistics of scripts/support_snr.py on codes C (D, n_cls, dim)."""
    n_draws, n_cls = C.shape[:2]
    mu = C.mean(axis=0)
    within = float(np.linalg.norm(C - mu[None], axis=-1).mean())
    across = float(np.linalg.norm(mu - mu.mean(0)[None], axis=-1).mean())
    correct = total = 0
    for d in range(len(C)):
        mu_o = np.delete(C, d, axis=0).mean(axis=0)
        for c in range(n_cls):
            correct += int(np.argmin(
                np.linalg.norm(mu_o - C[d, c][None], axis=-1)) == c)
            total += 1
    return {
        "n_cls": n_cls,
        "n_draws": n_draws,
        "within": round(within, 3),
        "across": round(across, 3),
        "ratio": round(across / max(within, 1e-9), 3),
        "nn_acc": round(correct / total, 3),
        "chance": round(1.0 / n_cls, 3),
    }


def measure(datacfg, darknetcfg, learnetcfg, weightfile=None, n_draws=6,
            seed=99, device="cuda"):
    return summarize(draw_codes(datacfg, darknetcfg, learnetcfg, weightfile,
                                n_draws, seed, device))


def main(argv=None):
    argv = list(sys.argv if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 4:
        print(__doc__)
        sys.exit(1)
    weights = argv[4] if len(argv) > 4 else None
    print(json.dumps(measure(argv[1], argv[2], argv[3], weights, device=device)))


if __name__ == "__main__":
    main()
