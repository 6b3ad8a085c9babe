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

Each target takes ``--device`` (default ``cuda``; ``cpu`` on a host
without a card). The ``torch`` and ``onnx`` targets take ``--checkpoint``
and ``--out`` only and raise: they need the rest of interop/ (ROADMAP.md,
modules to port, 'Other model families, interop, auto-discovery').
"""

from __future__ import annotations

import argparse

from ._common import add_model_args, model_config

_UNPORTED = ("torch", "onnx")
_DEVICE_HELP = ("torch device the checkpoint is exported on; 'cpu' for a "
                "host without a card")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT artifact export")
    sub = p.add_subparsers(dest="target", required=True)

    # the unported targets: their own flags come with them
    for name in _UNPORTED:
        pu = sub.add_parser(name)
        pu.add_argument("--checkpoint", required=True)
        pu.add_argument("--out", required=True)

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
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.target in _UNPORTED:
        raise NotImplementedError(
            f"export target {args.target!r} is not ported (ROADMAP.md, "
            "modules to port, 'Other model families, interop, "
            "auto-discovery'); the port exports the 'vit', 'ultranet', "
            "'hls' and 'refnpz' targets")
    if args.target in ("ultranet", "hls", "refnpz"):
        return _export_ultranet(args)

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
