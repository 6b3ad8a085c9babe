"""Artifact export CLI (port of ``quantized_vit_tpu/cli/export.py``):

  python -m quantized_vit_tpu_torch.cli.export vit      --checkpoint C --out D
  python -m quantized_vit_tpu_torch.cli.export ultranet --checkpoint C --out D
  python -m quantized_vit_tpu_torch.cli.export hls      --checkpoint C --out D
  python -m quantized_vit_tpu_torch.cli.export refnpz   --checkpoint C --out D

vit:      a trained fake-quant checkpoint (a full model, or the
          ``compressed`` subnet that ``cli.train`` writes, whose config
          rides in its extra) -> the integer serving artifact
          (``serve.export_vit_int4`` + ``artifact.save_vit_int4_artifact``),
          which ``cli.serve`` loads.
ultranet: an UltraNet checkpoint (params, BN statistics under
          ``batch_stats`` in its extra) or the reference's
          ``ultranet_4w4a.pt`` -> the integer artifact
          (``artifact.save_ultranet_artifact``) that ``UltraNetInt`` runs.
hls:      the same inputs -> the FPGA headers ``param.h``/``config.h``
          (``artifact.export_ultranet_hls``).
refnpz:   the same inputs -> the reference-format ``ultranet_4w4a.npz``
          and ``config.json`` (``interop.export_reference_ultranet``).
torch:    a ViT checkpoint (full or compressed, or a reference ``.pt``) ->
          ``model.pt``, the reference-style state dict
          (``interop.vit_params_to_torch``), and ``arch.json``, its
          ViTConfig as a dict: the interchange format of a model leaving
          the port (the reference pickles the sliced module,
          pruning_compression.py:385; a state dict + config is the same
          information without the pickle's code coupling).
onnx:     the same inputs -> the ONNX graph of the dense float model
          through the reference-shaped torch module
          (``interop.torch_model``; pruning_compression.py:374-391's onnx
          branch); needs the ``onnx`` package; ``--bake-quant`` folds the
          trained weight-quant levels into the float weights first.

Each target takes ``--device`` (default ``cuda``; ``cpu`` on a host
without a card).
"""

from __future__ import annotations

import argparse

from ._common import add_model_args, model_config

_DEVICE_HELP = ("torch device the checkpoint is exported on; 'cpu' for a "
                "host without a card")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT artifact export")
    sub = p.add_subparsers(dest="target", required=True)

    pu = sub.add_parser("ultranet")
    pu.add_argument("--checkpoint", required=True,
                    help="checkpoint prefix with params and batch_stats "
                         "(the stats under 'batch_stats' in its extra), or "
                         "the reference's ultranet_4w4a.pt")
    pu.add_argument("--out", required=True)
    pu.add_argument("--w-bit", type=int, default=4)
    pu.add_argument("--a-bit", type=int, default=4)
    pu.add_argument("--l-shift", type=int, default=8)
    pu.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    for name in ("hls", "refnpz"):
        ph = sub.add_parser(name)
        ph.add_argument("--checkpoint", required=True)
        ph.add_argument("--out", required=True)
        if name == "hls":
            ph.add_argument("--w-bit", type=int, default=4)
            ph.add_argument("--a-bit", type=int, default=4)
            ph.add_argument("--l-shift", type=int, default=8)
        ph.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    pv = sub.add_parser("vit")
    add_model_args(pv)
    pv.add_argument("--checkpoint", required=True)
    pv.add_argument("--out", required=True)
    pv.add_argument("--img-size", type=int, default=224)
    pv.add_argument("--num-classes", type=int, default=10)
    pv.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    pt = sub.add_parser(
        "torch", help="ViT checkpoint (full or compressed) -> reference-"
                      "style torch state dict (model.pt) + arch.json")
    add_model_args(pt)
    pt.add_argument("--checkpoint", required=True)
    pt.add_argument("--out", required=True,
                    help="output directory (model.pt + arch.json)")
    pt.add_argument("--img-size", type=int, default=224)
    pt.add_argument("--num-classes", type=int, default=10)
    pt.add_argument("--device", default="cuda", help=_DEVICE_HELP)

    po = sub.add_parser(
        "onnx", help="ViT checkpoint (full or compressed) -> ONNX graph of "
                     "the dense float model (needs the 'onnx' package)")
    add_model_args(po)
    po.add_argument("--checkpoint", required=True)
    po.add_argument("--out", required=True, help="output .onnx path")
    po.add_argument("--img-size", type=int, default=224)
    po.add_argument("--num-classes", type=int, default=10)
    po.add_argument("--bake-quant", action="store_true",
                    help="fold the trained weight-quant levels into the "
                         "float weights first")
    po.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    return p.parse_args(argv)


def _vit_checkpoint(args):
    """(params, ViTConfig) of ``--checkpoint``: a compressed checkpoint's
    config from its ``extra["subnet"]``, else ``--model``'s preset."""
    from ..models.layers import QuantConfig
    from ._common import load_params_any, vit_config_from_dict

    params, _, extra = load_params_any(args.checkpoint, device=args.device)
    if "subnet" in extra:
        return params, vit_config_from_dict(extra["subnet"])
    return params, model_config(args, QuantConfig(enabled=True))


def main(argv=None):
    args = parse_args(argv)
    if args.target in ("ultranet", "hls", "refnpz"):
        return _export_ultranet(args)
    if args.target == "torch":
        return _export_torch(args)
    if args.target == "onnx":
        return _export_onnx(args)

    from ..artifact import save_vit_int4_artifact
    from ..serve import export_vit_int4

    params, cfg = _vit_checkpoint(args)
    art = export_vit_int4(cfg, params)
    out = save_vit_int4_artifact(args.out, art, cfg)
    print(f"[export] vit int4 artifact -> {out}")
    return out


def _export_torch(args):
    import dataclasses
    import json
    import os

    import torch

    from ..interop import vit_params_to_torch

    params, cfg = _vit_checkpoint(args)
    sd = vit_params_to_torch(params)
    os.makedirs(args.out, exist_ok=True)
    pt_path = os.path.join(args.out, "model.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt_path)
    with open(os.path.join(args.out, "arch.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    print(f"[export] torch state dict -> {pt_path}, arch.json alongside")
    return args.out


def _export_onnx(args):
    import dataclasses

    from ..interop import vit_params_to_torch
    from ..interop.torch_model import (bake_weight_quant, build_torch_vit,
                                       export_onnx, load_interchange)

    params, cfg = _vit_checkpoint(args)
    if args.bake_quant:
        params = bake_weight_quant(params, cfg)
    model = build_torch_vit(dataclasses.asdict(cfg), device=args.device)
    load_interchange(model, vit_params_to_torch(params))
    out = export_onnx(args.out, model, cfg.img_size, cfg.in_channels)
    print(f"[export] onnx graph -> {out}")
    return out


def _export_ultranet(args):
    from ._common import load_params_any

    params, _, extra = load_params_any(args.checkpoint, device=args.device)
    stats = extra.get("batch_stats")
    if stats is None:
        raise SystemExit(
            "checkpoint lacks batch_stats in extra; re-save with "
            "save_checkpoint(..., extra={'batch_stats': stats})")
    from ..artifact import UltraNetExportConfig
    from ..artifact.ultranet import as_tensors

    stats = as_tensors(stats, args.device)
    if args.target == "refnpz":
        from ..interop import export_reference_ultranet

        npz_path, cfg_path = export_reference_ultranet(params, stats,
                                                       args.out)
        print(f"[export] reference npz -> {npz_path}, config -> {cfg_path}")
        return args.out
    exp = UltraNetExportConfig(w_bit=args.w_bit, a_bit=args.a_bit,
                               l_shift=args.l_shift)
    if args.target == "hls":
        from ..artifact import export_ultranet_hls

        export_ultranet_hls(params, stats, args.out, exp)
        print(f"[export] HLS headers (param.h, config.h) -> {args.out}")
        return args.out
    from ..artifact import save_ultranet_artifact

    out = save_ultranet_artifact(args.out, params, stats, exp)
    print(f"[export] ultranet integer artifact -> {out}")
    return out


if __name__ == "__main__":
    main()
