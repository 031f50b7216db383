"""Training entry point of the port (counterpart of ``cli.py``).

    python -m furusato_recommend_tpu_torch.cli --model lgn --recdim 64 --layer 2 \\
        --bpr_batch 8192 --lr 1e-3 --data_path ./data [--device cpu]

The flags are the JAX package's, with its defaults and choices, plus
``--device`` (default ``cuda``; raises without CUDA unless ``--device cpu``).
Every key of the JAX package's registry trains: the MF / LightGCN family and
the SAGE family (``textsage``, ``textsage_id``, ``sage``, ``fsage``,
``fastsage``, ``lightsage``, ``pinsage``, ``mrec``, ``nssage``, the attention
models ``tgrec`` and ``tgrec2``, ``gnn`` with any ``--conv``, the
edge-feature models ``tgsrec``, ``sasgnn`` (``cf/buy_timestamp``) and
``rsage`` (the favourite and review edge sets, ``--multi_relational``), the
sequence model ``sasrec`` (``train_items_sequence``, or the train items in
order), the attribute model ``asage`` (``attribute/*_attribute``, or the
categorical columns), and ``dask``, whose numeric matrices stay on disk), on
the reference's feature artifacts under
``--data_path`` (``data/features.py::load_reference_features``), with
``--ddp_recipe``, ``--sample_pow``, ``--inference sample`` and
``--feature_update_every``. ``--a_fold``, ``--compile_cache`` and
``--pipeline_dispatch`` concern the TPU layout and XLA: each prints a notice
and is ignored. ``--wandb NAME`` logs to a wandb run and ``--tensorboard 1``
to ``{path}/{model}/tb``, each falling back to the JSONL file and stdout when
its package is missing (``obs/log.py``); ``--ckpt_backend orbax`` raises.

``--mesh_data D --mesh_model M`` (D x M > 1) trains on a (data, model) mesh of
D x M processes, one a rank, launched by torchrun, which sets the world's
environment::

    torchrun --nproc_per_node 4 -m furusato_recommend_tpu_torch.cli --model lgn \
        --mesh_data 2 --mesh_model 2 --data_path ./data [--device cpu]

The mesh raises when there is no such world (no ``WORLD_SIZE``) or when
``WORLD_SIZE`` is not D x M. ``--device cuda`` puts rank r on card
``LOCAL_RANK``; ``--device cuda:0`` puts every rank on card 0.
The collectives' backend follows from the device
(``core/distributed.py::default_backend``): NCCL for ``cuda`` (one card a
rank), gloo on the CPU and for a named card that the host's ranks share
(staging CUDA tensors through host memory). Only rank 0 prints metrics and
writes files.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses

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
    p.add_argument("--a_fold", type=int, default=1000)
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
    p.add_argument("--pretrain", type=int, default=0)
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--model", type=str, default="lgn")
    p.add_argument("--train_emb", action="store_true")
    p.add_argument("--sample_pow", type=float, default=0.0)
    p.add_argument("--r", type=float, default=0.5)
    p.add_argument("--test_span", type=int, default=10)
    p.add_argument("--suffix", type=str, default="")
    p.add_argument("--multi_relational", type=str, default="add")
    p.add_argument("--conv", type=str, default="gcn")
    p.add_argument("--for_lgbm", action="store_true")
    p.add_argument("--lgbm_ratio", type=float, default=0.1)
    p.add_argument("--cold_start", action="store_true")
    p.add_argument("--user_feature", type=str, default="ntw")
    p.add_argument("--item_feature", type=str, default="ntw")
    p.add_argument("--factorization", action="store_true")
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--ddp_recipe", action="store_true", help="weighted+capped DDP sampler recipe")
    p.add_argument("--loss_fn", type=str, default="bpr", choices=["bpr", "infonce"])
    p.add_argument("--ckpt_backend", type=str, default="npz", choices=["npz", "orbax"])
    p.add_argument("--auc", action="store_true")
    p.add_argument("--feature_update_every", type=int, default=1,
                   help="T>1: the feature parameters take one Adam step per T steps")
    p.add_argument("--compile_cache", type=str, default="", help="XLA's; ignored")
    p.add_argument("--pipeline_dispatch", action=argparse.BooleanOptionalAction, default=True,
                   help="the JAX package's epoch prefetch; ignored")
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
        pretrain=bool(args.pretrain),
        r=args.r,
        conv=args.conv,
        multi_relational=args.multi_relational,
        inference=args.inference,
        train_emb=args.train_emb,
        sample_pow=args.sample_pow,
        factorization=args.factorization,
        test_mode=args.test,
        cold_start=args.cold_start,
        for_lgbm=args.for_lgbm,
        lgbm_ratio=args.lgbm_ratio,
        suffix=args.suffix,
        user_feature=args.user_feature,
        item_feature=args.item_feature,
        path=args.path,
        data_path=args.data_path,
        wandb=args.wandb,
        tensorboard=bool(args.tensorboard),
        comment=args.comment,
        load=bool(args.load),
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model),
        ckpt_backend=args.ckpt_backend,
        loss_fn=args.loss_fn,
        compute_auc=args.auc,
        feature_update_every=args.feature_update_every,
        compile_cache=args.compile_cache,
        pipeline_dispatch=args.pipeline_dispatch,
    )


def build_model_inputs(config: Config, dataset):
    """(graph, model keyword arguments) for ``build_model``: the SAGE-family
    keys get ``features=``, the reference's artifacts under config.data_path;
    ``dask`` leaves the numeric matrices on disk and gets them as
    ``ooc_numeric={side: MemmapNumeric}``. For ``rsage``, when the relation
    edge sets are there, the dataset's graph becomes the relational graph
    (so that the trainer, the evaluator and the server propagate over it)
    and the features get its edge labels. ``sasrec`` gets ``sequences=``:
    the reference's ``train_items_sequence{sfx}.pkl`` (and its lengths) when
    it exists, else the train items in the data's order; ``asage`` gets its
    attribute graphs from ``attribute/*_attribute{sfx}.pt`` when they exist,
    else derives them from the categorical features (flag ``c``)."""
    from .models.registry import SAGE_KEYS

    model_kw = {}
    if config.model in SAGE_KEYS:
        from .data.features import (
            load_attribute_coos,
            load_reference_features,
            load_relation_edges,
            numeric_artifact_paths,
        )

        ooc = config.model == "dask"
        model_kw["features"] = load_reference_features(
            config, config.data_path, dataset=dataset, skip_numeric=ooc
        )
        if ooc:
            from .data.ooc import MemmapNumeric

            paths = numeric_artifact_paths(config, config.data_path)
            if paths:
                model_kw["ooc_numeric"] = {side: MemmapNumeric(p) for side, p in paths.items()}
        if config.model == "rsage":
            from .data.graph import build_relational_graph

            rel = load_relation_edges(config, config.data_path)
            if rel:
                dataset._graph, labels = build_relational_graph(dataset, rel)
                model_kw["features"] = dataclasses.replace(
                    model_kw["features"], edge_label=labels, n_relations=len(rel) + 1
                )
        if config.model == "sasrec":
            from pathlib import Path

            from .data.sequence import build_sequences, load_sequence_artifacts

            if (Path(config.data_path) / f"train_items_sequence{config.suffix}.pkl").exists():
                model_kw["sequences"] = load_sequence_artifacts(
                    config.data_path, config.suffix, n_users=dataset.n_users
                )
            else:
                model_kw["sequences"] = build_sequences(dataset)
        if config.model == "asage":
            model_kw.update(load_attribute_coos(config, config.data_path) or {})
    return dataset.graph, model_kw


#: flags of the JAX package that concern its TPU layout or XLA, and why the
#: port ignores them
_IGNORED = {
    "a_fold": "the port's SpMM needs no folding of the adjacency",
    "compile_cache": "the port runs eagerly and compiles no epoch program",
    "pipeline_dispatch": "the device queue already overlaps the host",
}


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    config = config_from_args(args)
    if config.ckpt_backend == "orbax":
        raise NotImplementedError("--ckpt_backend orbax is JAX's; the port writes its own .npz checkpoints")
    for attr, why in _IGNORED.items():
        if getattr(args, attr) != parser.get_default(attr):
            print(f"[cli] --{attr} is ignored: {why}")

    from .core.device import resolve_device
    from .core.distributed import shutdown

    if config.mesh.num_devices == 1:
        _train(args, config, resolve_device(args.device))
        return
    device = join_mesh_world(config.mesh, args.device)
    try:
        _train(args, config, device)
    finally:
        shutdown()


def join_mesh_world(mesh, device: str):
    """Join the world of a (data, model) mesh from torchrun's environment,
    over ``default_backend(device)``; returns this rank's device. Raises
    when there is no such world or it has another size."""
    import os

    from .core.distributed import default_backend, initialize_multihost, rank_device

    need = mesh.num_devices
    if "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            f"--mesh_data {mesh.data} --mesh_model {mesh.model} needs {need} processes: launch with "
            f"torchrun --nproc_per_node {need} -m furusato_recommend_tpu_torch.cli ... (no WORLD_SIZE is set)"
        )
    if int(os.environ["WORLD_SIZE"]) != need:
        raise RuntimeError(
            f"--mesh_data {mesh.data} --mesh_model {mesh.model} needs {need} processes, but WORLD_SIZE is "
            f"{os.environ['WORLD_SIZE']}"
        )
    dev = rank_device(device)
    initialize_multihost(world_size=need, backend=default_backend(device), device=dev)
    return dev


def _train(args, config: Config, device) -> None:
    from .core.distributed import is_primary_host
    from .data import load_text_dataset
    from .models.registry import build_model
    from .obs.log import MetricLogger, cprint
    from .train.trainer import Trainer

    primary = is_primary_host()
    if primary:
        cprint(f"[furusato_recommend_tpu_torch] model={config.model} dim={config.latent_dim} device={device}")
    dataset = load_text_dataset(config)
    if primary:
        print(
            f"{dataset.train_size} train / {dataset.test_size} test interactions; "
            f"sparsity {dataset.sparsity():.6f}"
        )
    graph, model_kw = build_model_inputs(config, dataset)
    model = build_model(config.model, config, graph, **model_kw)
    logger = MetricLogger(
        jsonl_path=f"{config.path}/{config.model}/metrics.jsonl",
        wandb_run=(None if config.test_mode else config.wandb or None),
        tensorboard_dir=(f"{config.path}/{config.model}/tb" if config.tensorboard else None),
    ) if primary else MetricLogger(quiet=True)
    try:
        trainer = Trainer(config, dataset, model, logger=logger, ddp_recipe=args.ddp_recipe, device=device)
        resume = False
        if config.load:
            from .core.checkpoint import checkpoint_path

            ckpt = checkpoint_path(config)
            if ckpt.exists():
                trainer.restore(ckpt)
                resume = True
                if primary:
                    cprint(f"[load] warm-started from {ckpt} @ step {trainer.step}")
            elif primary:
                cprint(f"[load] no checkpoint at {ckpt}; training from scratch")
        trainer.fit(resume=resume)
    finally:
        logger.close()


if __name__ == "__main__":
    main()
