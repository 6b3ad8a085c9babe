"""Training CLI: ViT QAT + joint structured pruning with GETA, then the
compressed subnet (port of ``quantized_vit_tpu/cli/train.py``).

The same steps as the JAX CLI: build the loaders, wrap the ViT with
learned-scale quantizers at ``--max-bit``, build the OTO node groups, mark
patch_embed/pos_embed/cls_token/head unprunable, derive the projection and
pruning schedule in steps from the epoch budget, train with a cosine LR
(evaluating, logging and checkpointing each epoch), then construct the
compressed subnet and report full against compressed MACs, BOPs, params
and weight bits. Writes under ``--out-dir``: ``tb/metrics.jsonl`` (and
TensorBoard events), the ``best``, ``final`` and ``ckpt_step_*``
checkpoints, ``compressed`` (the subnet's params, with its config and bit
widths in the extra) and ``history.json``.

It iterates the port's ``DataLoader`` directly (the JAX CLI wraps it in a
prefetch thread). Runs on the card unless ``--device cpu``;
``--fused-vjp`` puts K7 (``csrc/quant_bwd.cu``) on every nonlinear
quantizer's backward.

    python -m quantized_vit_tpu_torch.cli.train --model vit_tiny_test \\
        --img-size 32 --epochs 2 --out-dir runs/train
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import numpy as np

from ._common import (add_dataset_args, add_model_args, build_datasets,
                      build_model, load_params_any, set_seed)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="QViT GETA training")
    add_dataset_args(p)
    add_model_args(p)
    # optimizer
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lrf", type=float, default=0.01,
                   help="final lr fraction for the cosine schedule")
    p.add_argument("--lr-quant", type=float, default=1e-3)
    p.add_argument("--variant", default="adam",
                   choices=["sgd", "adam", "adamw"])
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--target-group-sparsity", type=float, default=0.5)
    p.add_argument("--group-divisible", type=int, default=1)
    # projection / pruning schedule
    p.add_argument("--projection-start-epochs", type=float, default=1.0)
    p.add_argument("--projection-epochs", type=float, default=2.0)
    p.add_argument("--projection-periods", type=int, default=6)
    p.add_argument("--pruning-epochs", type=float, default=1.0)
    p.add_argument("--pruning-periods", type=int, default=5)
    p.add_argument("--bit-reduction", type=float, default=4.0)
    p.add_argument("--min-bit", type=float, default=4.0)
    p.add_argument("--max-bit", type=float, default=32.0)
    # loss config
    p.add_argument("--mix-up", action="store_true")
    p.add_argument("--label-smooth", action="store_true")
    p.add_argument("--use-kd", action="store_true")
    p.add_argument("--kd-alpha", type=float, default=0.5)
    p.add_argument("--kd-temperature", type=float, default=4.0)
    p.add_argument("--use-group-lasso", action="store_true")
    p.add_argument("--group-lasso-lambda", type=float, default=1e-4)
    p.add_argument("--gl-start-epoch", type=int, default=0)
    # misc
    p.add_argument("--fused-vjp", action="store_true",
                   help="the fused single-pass quantizer backward (kernel "
                        "K7 on the card)")
    p.add_argument("--matmul-dtype", default=None,
                   choices=[None, "bfloat16"],
                   help="mixed-precision QAT: dense/conv/attention dots on "
                        "bf16 operands, quantizer math stays f32")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-dir", default="runs/train")
    p.add_argument("--no-tensorboard", action="store_true",
                   help="disable TensorBoard event files (JSONL still kept)")
    p.add_argument("--profile-epoch", type=int, default=-1,
                   help="capture a torch.profiler trace of this epoch")
    p.add_argument("--save-freq", type=int, default=0,
                   help="save a resumable checkpoint every N epochs (0=off)")
    p.add_argument("--resume", default="",
                   help="checkpoint to resume optimizer+params from")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def cosine_lr(epoch: int, epochs: int, lr: float, lrf: float) -> float:
    """The reference's LambdaLR cosine schedule."""
    return lr * (((1 + math.cos(epoch * math.pi / epochs)) / 2)
                 * (1 - lrf) + lrf)


def main(argv=None):
    args = parse_args(argv)
    set_seed(args.seed)
    os.makedirs(args.out_dir, exist_ok=True)

    import torch

    from ..device import resolve_device
    from ..graph import OTO
    from ..models import (QuantConfig, apply, flatten_tree,
                          init_quant_params_tree, tree_map)
    from ..opt.checkpoint import save_checkpoint
    from ..utils import DataLoader, TrainLoop, evaluate
    from ..utils.logging import MetricsWriter, profile_trace

    dev = resolve_device(args.device)
    train_ds, val_ds = build_datasets(args)
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed)
    val_loader = DataLoader(val_ds, args.batch_size, pad_last=True)
    steps_per_epoch = max(len(train_loader), 1)

    # the model wrapped with learned-scale quantizers at --max-bit
    model, cfg = build_model(
        args, QuantConfig(enabled=True, matmul_dtype=args.matmul_dtype,
                          fused_vjp=args.fused_vjp),
        device=dev, seed=args.seed)
    params = init_quant_params_tree(
        tree_map(lambda p: p.detach().clone(), model.param_tree()),
        init_bits=args.max_bit)
    if args.weights:
        params, _, _ = load_params_any(args.weights, device=dev)
    n_params = sum(int(np.prod(tuple(x.shape)))
                   for x in flatten_tree(params).values())
    print(f"[train] model {args.model}: {n_params/1e6:.1f}M params, "
          f"{steps_per_epoch} steps/epoch")

    oto = OTO(model, params)
    oto.mark_unprunable_by_param_names(
        ["patch_embed", "pos_embed", "cls_token", "head"])

    # the schedule in steps
    start_proj = int(args.projection_start_epochs * steps_per_epoch)
    proj_steps = max(int(args.projection_epochs * steps_per_epoch), 1)
    prune_start = start_proj + proj_steps
    prune_steps = max(int(args.pruning_epochs * steps_per_epoch), 1)
    opt = oto.geta(
        lr=args.lr, lr_quant=args.lr_quant, variant=args.variant,
        weight_decay=args.weight_decay,
        target_group_sparsity=args.target_group_sparsity,
        group_divisible=args.group_divisible,
        start_projection_step=start_proj,
        projection_steps=proj_steps,
        projection_periods=args.projection_periods,
        start_pruning_step=prune_start,
        pruning_steps=prune_steps,
        pruning_periods=args.pruning_periods,
        bit_reduction=args.bit_reduction,
        min_bit_wt=args.min_bit, max_bit_wt=args.max_bit,
        min_bit_act=args.min_bit, max_bit_act=args.max_bit,
    )
    if args.resume:
        params, opt_state, _ = load_params_any(args.resume, device=dev)
        if opt_state:
            opt.load_state_dict(opt_state)
        print(f"[train] resumed from {args.resume} at step {opt.num_steps}")

    def apply_fn(p, x, generator):
        return apply(model, p, x, deterministic=False, generator=generator)

    teacher_fn = None
    if args.use_kd:
        # self-distillation from the frozen float model of the same seed
        t_model, _ = build_model(args, QuantConfig.off(), device=dev,
                                 seed=args.seed)
        t_params = tree_map(lambda p: p.detach().clone(),
                            t_model.param_tree())

        def teacher_fn(x):
            return apply(t_model, t_params, x, deterministic=True)

    loop = TrainLoop(
        apply_fn=apply_fn, optimizer=opt, num_classes=args.num_classes,
        mix_up=args.mix_up, label_smooth=args.label_smooth,
        teacher_fn=teacher_fn, kd_alpha=args.kd_alpha if args.use_kd else 0.0,
        kd_temperature=args.kd_temperature,
        use_group_lasso=args.use_group_lasso,
        group_lasso_lambda=args.group_lasso_lambda,
        gl_start_epoch=args.gl_start_epoch, device=dev)

    def eval_apply(p, x):
        return apply(model, p, x, deterministic=True)

    writer = MetricsWriter(os.path.join(args.out_dir, "tb"),
                           use_tensorboard=not args.no_tensorboard)
    history = []
    best_top1 = -1.0
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for epoch in range(args.epochs):
        opt.set_lr(cosine_lr(epoch, args.epochs, args.lr, args.lrf))
        with profile_trace(os.path.join(args.out_dir, "profile"),
                           enabled=epoch == args.profile_epoch):
            params, tm = loop.train_one_epoch(params, train_loader, epoch,
                                              gen)
        em = evaluate(eval_apply, params, val_loader, device=dev)
        sm = opt.compute_metrics(params)
        avg_bits = oto.compute_average_bit_width(params)
        tm = {k: v for k, v in tm.items() if k != "step_losses"}
        rec = {"epoch": epoch, "lr": opt.cfg.lr, **tm,
               "val_top1": em["top1"], "val_top5": em.get("top5", 0.0),
               "group_sparsity": sm["group_sparsity"],
               "avg_wt_bit": avg_bits}
        history.append(rec)
        writer.add_scalars(rec, step=epoch)
        writer.flush()
        print(f"[epoch {epoch}] loss {tm['loss']:.4f} acc {tm['acc']:.3f} "
              f"val_top1 {em['top1']:.3f} sparsity "
              f"{sm['group_sparsity']:.3f} avg_bits {avg_bits:.2f}")
        if em["top1"] > best_top1:
            best_top1 = em["top1"]
            save_checkpoint(os.path.join(args.out_dir, "best"), params,
                            opt.state_dict(), {"epoch": epoch, **em})
        if args.save_freq and (epoch + 1) % args.save_freq == 0:
            save_checkpoint(
                os.path.join(args.out_dir, f"ckpt_step_{opt.num_steps}"),
                params, opt.state_dict(), {"epoch": epoch})

    save_checkpoint(os.path.join(args.out_dir, "final"), params,
                    opt.state_dict(), {"epochs": args.epochs})

    # ---- compression + report ----
    full = {"macs": oto.compute_macs(params),
            "bops": oto.compute_bops(params),
            "params": oto.compute_num_params(params),
            "weight_bits": oto.compute_weight_size(params)}
    new_model, new_params = oto.construct_subnet(params)
    oto2 = OTO(new_model, new_params)
    comp = {"macs": oto2.compute_macs(new_params),
            "bops": oto2.compute_bops(new_params),
            "params": oto2.compute_num_params(new_params),
            "weight_bits": oto2.compute_weight_size(new_params)}
    print(f"[compress] MACs {full['macs']/1e6:.1f}M -> "
          f"{comp['macs']/1e6:.1f}M | BOPs {full['bops']/1e9:.2f}G -> "
          f"{comp['bops']/1e9:.2f}G | params {full['params']/1e6:.2f}M -> "
          f"{comp['params']/1e6:.2f}M")
    bit_dict = opt.bitwidth_dict(params)
    for lp, bits in sorted(bit_dict.items()):
        print(f"  [bits] {lp}: {bits}")
    save_checkpoint(os.path.join(args.out_dir, "compressed"), new_params,
                    None, {"subnet": dataclasses.asdict(new_model.cfg),
                           "bit_dict": bit_dict})
    with open(os.path.join(args.out_dir, "history.json"), "w") as f:
        json.dump({"history": history, "full": full, "compressed": comp,
                   "best_top1": best_top1}, f, indent=1)
    writer.close()
    return history


if __name__ == "__main__":
    main()
