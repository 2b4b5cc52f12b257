"""Weight-file truncation for pretrained-backbone extraction (the
reference's partial.py): the first `cutoff` layers of `weightfile`, read
against `cfgfile`, written to `outfile` with a zero `seen` counter. Host
code only; `partial_torch.py` is its command line."""


def partial(cfgfile, weightfile, outfile, cutoff):
    from ..config import parse_cfg
    from ..models import weights_io
    from ..models.darknet import init_params
    from ..models.spec import build_spec

    spec = build_spec(parse_cfg(cfgfile))
    params = init_params(spec, 0)
    (params,), _ = weights_io.load_weights(weightfile, [spec], [params])
    weights_io.save_weights(outfile, [spec], [params], seen=0, cutoff=cutoff)
    print(f"save {outfile}")
