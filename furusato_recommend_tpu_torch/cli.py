"""Training entry point of the port (counterpart of ``cli.py``).

    python -m furusato_recommend_tpu_torch.cli --model lgn --recdim 64 --layer 2 \\
        --bpr_batch 8192 --lr 1e-3 --data_path ./data [--device cpu]

The flags are the JAX package's, plus ``--device`` (default ``cuda``; raises
without CUDA unless ``--device cpu``). The MF / LightGCN family trains (``mf``,
``lgn``, ``rgcn``, ``radj``, ``lgcnssm``); other models, the weighted sampling
recipes, ``--inference sample``, a mesh and the wandb / tensorboard sinks are
not ported yet and raise.
"""

from __future__ import annotations

import argparse
import ast

from .config import Config, MeshConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="furusato_recommend_tpu_torch trainer")
    p.add_argument("--bpr_batch", type=int, default=2048)
    p.add_argument("--recdim", type=int, default=64)
    p.add_argument("--layer", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decay", type=float, default=1e-7)
    p.add_argument("--dropout", type=int, default=0)
    p.add_argument("--keepprob", type=float, default=0.6)
    p.add_argument("--num_neighbors", type=int, default=5)
    p.add_argument("--testbatch", type=int, default=10000)
    p.add_argument("--dataset", type=str, default="furusato")
    p.add_argument("--path", type=str, default="./checkpoints")
    p.add_argument("--data_path", type=str, default="./data")
    p.add_argument("--topks", nargs="?", default="[10,20]")
    p.add_argument("--tensorboard", type=int, default=0)
    p.add_argument("--wandb", type=str, default="")
    p.add_argument("--inference", type=str, default="all")
    p.add_argument("--test", action="store_true")
    p.add_argument("--comment", type=str, default="lgn")
    p.add_argument("--load", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--model", type=str, default="lgn")
    p.add_argument("--sample_pow", type=float, default=0.0)
    p.add_argument("--r", type=float, default=0.5)
    p.add_argument("--test_span", type=int, default=10)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--for_lgbm", action="store_true")
    p.add_argument("--lgbm_ratio", type=float, default=0.1)
    p.add_argument("--cold_start", action="store_true")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--ddp_recipe", action="store_true")
    p.add_argument("--loss_fn", type=str, default="bpr", choices=["bpr", "infonce"])
    p.add_argument("--auc", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        model=args.model,
        dataset=args.dataset,
        bpr_batch_size=args.bpr_batch,
        latent_dim=args.recdim,
        n_layers=args.layer,
        lr=args.lr,
        decay=args.decay,
        dropout=bool(args.dropout),
        keep_prob=args.keepprob,
        num_neighbors=args.num_neighbors,
        eval_user_batch=args.testbatch,
        topks=tuple(ast.literal_eval(args.topks)),
        epochs=args.epochs,
        test_span=args.test_span,
        seed=args.seed,
        r=args.r,
        inference=args.inference,
        sample_pow=args.sample_pow,
        test_mode=args.test,
        cold_start=args.cold_start,
        for_lgbm=args.for_lgbm,
        lgbm_ratio=args.lgbm_ratio,
        suffix=args.suffix,
        path=args.path,
        data_path=args.data_path,
        wandb=args.wandb,
        tensorboard=bool(args.tensorboard),
        comment=args.comment,
        load=bool(args.load),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        loss_fn=args.loss_fn,
        compute_auc=args.auc,
    )


def main(argv=None):
    args = build_argparser().parse_args(argv)
    config = config_from_args(args)
    if config.wandb or config.tensorboard:
        raise NotImplementedError("the wandb and tensorboard sinks are not ported yet")

    from .core.device import resolve_device
    from .data import load_text_dataset
    from .models.registry import build_model
    from .obs.log import MetricLogger, cprint
    from .train.trainer import Trainer

    device = resolve_device(args.device)
    cprint(f"[furusato_recommend_tpu_torch] model={config.model} dim={config.latent_dim} device={device}")
    dataset = load_text_dataset(config)
    print(
        f"{dataset.train_size} train / {dataset.test_size} test interactions; "
        f"sparsity {dataset.sparsity():.6f}"
    )
    model = build_model(config.model, config, dataset.graph)
    logger = MetricLogger(jsonl_path=f"{config.path}/{config.model}/metrics.jsonl")
    try:
        trainer = Trainer(config, dataset, model, logger=logger, ddp_recipe=args.ddp_recipe, device=device)
        resume = False
        if config.load:
            from .core.checkpoint import checkpoint_path

            ckpt = checkpoint_path(config)
            if ckpt.exists():
                trainer.restore(ckpt)
                resume = True
                cprint(f"[load] warm-started from {ckpt} @ step {trainer.step}")
            else:
                cprint(f"[load] no checkpoint at {ckpt}; training from scratch")
        trainer.fit(resume=resume)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
