"""Artifact export CLI (port of ``quantized_vit_tpu/cli/export.py``,
the ``vit`` target):

  python -m quantized_vit_tpu_torch.cli.export vit --checkpoint C --out D

vit: a trained fake-quant checkpoint (a full model, or the ``compressed``
     subnet that ``cli.train`` writes, whose config rides in its extra)
     -> the integer serving artifact (``serve.export_vit_int4`` +
     ``artifact.save_vit_int4_artifact``), which ``cli.serve`` loads.

The ``ultranet``, ``hls``, ``refnpz``, ``torch`` and ``onnx`` targets
take ``--checkpoint`` and ``--out`` only and raise: they need the other
model families and interop/ (ROADMAP.md, modules to port, 'Other model
families, interop, auto-discovery').
"""

from __future__ import annotations

import argparse

from ._common import add_model_args, model_config

_UNPORTED = ("ultranet", "hls", "refnpz", "torch", "onnx")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT artifact export")
    sub = p.add_subparsers(dest="target", required=True)

    # the unported targets: their own flags come with them
    for name in _UNPORTED:
        pu = sub.add_parser(name)
        pu.add_argument("--checkpoint", required=True)
        pu.add_argument("--out", required=True)

    pv = sub.add_parser("vit")
    add_model_args(pv)
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--out", required=True)
    pv.add_argument("--img-size", type=int, default=224)
    pv.add_argument("--num-classes", type=int, default=10)
    pv.add_argument("--device", default="cuda",
                    help="torch device the checkpoint is exported on; "
                         "'cpu' for a host without a card")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.target in _UNPORTED:
        raise NotImplementedError(
            f"export target {args.target!r} is not ported (ROADMAP.md, "
            "modules to port, 'Other model families, interop, "
            "auto-discovery'); the port exports the 'vit' target")

    from ..artifact import save_vit_int4_artifact
    from ..models.layers import QuantConfig
    from ..serve import export_vit_int4
    from ._common import load_params_any, vit_config_from_dict

    params, _, extra = load_params_any(args.checkpoint, device=args.device)
    if "subnet" in extra:
        cfg = vit_config_from_dict(extra["subnet"])
    else:
        cfg = model_config(args, QuantConfig(enabled=True))
    art = export_vit_int4(cfg, params)
    out = save_vit_int4_artifact(args.out, art, cfg)
    print(f"[export] vit int4 artifact -> {out}")
    return out


if __name__ == "__main__":
    main()
