"""Checkpoint and ranker tools of the port (counterpart of ``tools.py``):

  python -m furusato_recommend_tpu_torch.tools evaluate --ckpt ... [--save_result out.csv]
  python -m furusato_recommend_tpu_torch.tools infer --ckpt ... --target_batches 0,9 --k 20
  python -m furusato_recommend_tpu_torch.tools recommend --ckpt ... --users 3,17 --k 10
  python -m furusato_recommend_tpu_torch.tools dump-candidates --ckpt ... --k 50
  python -m furusato_recommend_tpu_torch.tools train-ranker --candidates a.npy b.npy
  python -m furusato_recommend_tpu_torch.tools rerank-eval --candidates a.npy b.npy --ranker r.ckpt
  python -m furusato_recommend_tpu_torch.tools preprocess --products p.csv --customers c.csv \
      --transactions t.csv --out ./data
  python -m furusato_recommend_tpu_torch.tools convert-recbole --interactions t.csv --out ./recbole

The checkpoint subcommands load a checkpoint of the port (``Trainer.save`` or
``core.checkpoint.save_checkpoint``; ``tools/export_jax_checkpoint.py``
converts one of the JAX package's) and rebuild its dataset and model from the
reference's layout under the config's ``data_path`` (or ``--data_path``):

- ``evaluate``: the full-catalog metrics as JSON, and with ``--save_result``
  the per-user CSV of every test user at ``topks[0]``;
- ``infer``: one propagation over the inference edge set, a masked top-k per
  target batch of users masking only the train positives, one CSV a batch
  (``eval/inference.py``);
- ``recommend``: one JSON line a user through ``serve.Recommender``;
- ``dump-candidates``: every user's top k with the train positives masked,
  ``candidates_<model>.npy`` (``rank/pipeline.py::dump_candidates``).

The two-stage ranker's subcommands read the data directory's ``nc`` features:

- ``train-ranker``: the ``for_lgbm`` split (``lgbm_ratio / 0.7`` of each
  user's items held out), the candidate dumps labelled by the held-out edges,
  a ``NeuralRanker`` fit, its parameters saved under the JAX names;
- ``rerank-eval``: that ranker re-ranks the dumps' union; recall, ndcg and
  hit rate at k on the test split as JSON.

The preprocessing subcommands run on the host alone, on CSV (or, with
pandas, ``.pkl``) tables:

- ``preprocess``: raw product, customer and transaction tables (and the
  optional category, partner and review tables) to the artifact directory
  that ``--data_path`` then names (``preprocessing/pipeline.py``), its summary
  as JSON;
- ``convert-recbole``: an interaction table, k-core filtered when asked, to
  RecBole's atomic files (``preprocessing/filtering.py``).

The flags are the JAX package's, with its defaults; the subcommands that use
the card also take ``--device`` (default ``cuda``; raises without CUDA unless
``--device cpu``). ``main`` returns what the subcommand computed, with the
host seconds of its parts under ``"seconds"`` (``obs.log.step_timer``, which
does not wait for the card: a part that needs the card's results waits for
them).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np

__all__ = ["main"]

#: the subcommands that run on the host alone and take no --device
_HOST_ONLY = ("preprocess", "convert-recbole")


class _Seconds:
    """A ``step_timer`` sink: the seconds of each name, summed over its blocks."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    def log(self, metrics, step=None) -> None:
        for key, v in metrics.items():
            name = key.removeprefix("time/")
            self.seconds[name] = self.seconds.get(name, 0.0) + float(v)


def _load_run(args):
    """(config, dataset, model on the device with the checkpoint's parameters)."""
    from .cli import build_argparser, build_model_inputs, config_from_args
    from .config import Config
    from .convert import params_from_jax
    from .core.checkpoint import load_checkpoint
    from .data.dataset import load_text_dataset
    from .models.registry import build_model

    state = load_checkpoint(args.ckpt)
    cfg_json = state.get("__config__")
    config = (
        Config.from_json(json.dumps(cfg_json))
        if cfg_json
        else config_from_args(build_argparser().parse_args([]))
    )
    if args.data_path:
        config = config.replace(data_path=args.data_path)
    dataset = load_text_dataset(config)
    graph, model_kw = build_model_inputs(config, dataset)
    model = build_model(config.model, config, graph, **model_kw)
    params_from_jax(state["params"], model)
    return config, dataset, model.to(args.device)


def cmd_evaluate(args):
    """``tools evaluate``: one evaluation of a checkpoint, printed (and
    written with ``--save_result``). It is its Evaluator's first call, so it
    runs eagerly: the warm-up after which a second call would capture the
    evaluation (``eval/graphed.py``)."""
    from .eval.evaluate import Evaluator, build_eval_data
    from .obs.log import step_timer

    timer = _Seconds()
    with step_timer("load", timer):
        config, dataset, model = _load_run(args)
    with step_timer("evaluate", timer, trace=True):
        max_deg = int(np.max(np.bincount(dataset.train_user, minlength=dataset.n_users)))
        ev = Evaluator(model, dataset.graph.to(args.device), config, max_train_degree=max_deg)
        data = build_eval_data(dataset, config.eval_user_batch, device=args.device)
        results, topk = ev(data)
    print(json.dumps({k: round(v, 6) for k, v in results.items()}, indent=2))
    if args.save_result:
        from .eval.results import save_result

        with step_timer("csv", timer, trace=True):
            save_result(args.save_result, dataset, topk, k=config.topks[0])
        print(f"wrote {args.save_result}")
    return {"results": results, "topk": topk, "seconds": timer.seconds}


def cmd_infer(args):
    """Checkpoint -> propagation over the inference edge set -> per target
    batch a masked top-k and a CSV."""
    from .eval.inference import production_inference
    from .obs.log import step_timer

    timer = _Seconds()
    with step_timer("load", timer):
        config, dataset, model = _load_run(args)
    if not dataset.has_inference_edges:
        print(
            "[infer] no separate inference edge set (need --suffix all or an "
            "inference{suffix}.txt); propagating over train edges"
        )
    target = [int(t) for t in args.target_batches.split(",") if t != ""]
    paths = production_inference(
        model,
        None,
        dataset,
        config,
        out_dir=args.out_dir,
        user_batch_size=args.user_batch,
        target_batches=target,
        k=args.k,
        device=args.device,
        sink=timer,
    )
    print(f"wrote {len(paths)} csv(s)")
    return {"paths": paths, "seconds": timer.seconds}


def cmd_recommend(args):
    """Checkpoint -> propagated embeddings kept on the device -> masked top-k
    for the requested users (``serve.Recommender``)."""
    from .obs.log import step_timer
    from .serve import Recommender

    timer = _Seconds()
    with step_timer("load_and_propagate", timer, trace=True):
        rec = Recommender.from_checkpoint(
            args.ckpt,
            data_path=args.data_path,
            use_inference_edges=not args.train_edges_only,
            device=args.device,
        )
    users = [int(u) for u in args.users.split(",") if u != ""]
    with step_timer("topk", timer, trace=True):
        ids, scores = rec.recommend(users, k=args.k)
    lines = [
        json.dumps({"user": u, "items": row.tolist(), "scores": [round(float(s), 4) for s in srow]})
        for u, row, srow in zip(users, ids, scores)
    ]
    for line in lines:
        print(line)
    return {"lines": lines, "ids": ids, "scores": scores, "seconds": timer.seconds}


def cmd_dump_candidates(args):
    """Checkpoint -> propagation -> every user's masked top k, saved as .npy."""
    from .obs.log import step_timer
    from .rank.pipeline import dump_candidates

    timer = _Seconds()
    with step_timer("load", timer):
        config, dataset, model = _load_run(args)
    with step_timer("dump", timer, trace=True):
        cands = dump_candidates(model, dataset.graph, k=args.k, device=args.device)
    out = args.out or f"candidates_{config.model}.npy"
    with step_timer("save", timer):
        np.save(out, cands)
    print(f"wrote {out} shape={cands.shape}")
    return {"path": out, "candidates": cands, "seconds": timer.seconds}


def _ranker_inputs(config):
    """(dataset, features) of the ranker's data directory."""
    from .data.dataset import load_text_dataset
    from .data.features import load_reference_features

    return load_text_dataset(config), load_reference_features(config, config.data_path)


def cmd_train_ranker(args):
    """Candidate dumps -> labelled groups over the for_lgbm holdout ->
    ``NeuralRanker.fit`` -> checkpoint."""
    from .config import Config
    from .convert import ranker_params_to_numpy
    from .core.checkpoint import save_checkpoint
    from .data.dataset import load_text_dataset
    from .obs.log import step_timer
    from .rank.pipeline import build_rank_groups
    from .rank.ranker import NeuralRanker

    timer = _Seconds()
    # make_X reads the numeric and categorical columns
    config = Config(data_path=args.data_path, for_lgbm=True, lgbm_ratio=args.lgbm_ratio,
                    user_feature="nc", item_feature="nc")
    with step_timer("load", timer):
        dataset, features = _ranker_inputs(config)
        full = load_text_dataset(config.replace(for_lgbm=False))
        cands = [np.load(p) for p in args.candidates]
    with step_timer("groups", timer):
        # held out: the full edge set less the for_lgbm train set, one
        # setdiff over flat (user, item) keys
        m = np.int64(full.m_items)
        key_full = full.train_user.astype(np.int64) * m + full.train_item
        key_train = dataset.train_user.astype(np.int64) * m + dataset.train_item
        held_keys = np.setdiff1d(key_full, key_train)
        groups = build_rank_groups(dataset, cands, holdout=(held_keys // m, held_keys % m))
    with step_timer("fit", timer, trace=True):
        ranker = NeuralRanker(features).to(args.device)
        losses = ranker.fit(groups, epochs=args.epochs, verbose=True).cpu().numpy()
    with step_timer("save", timer):
        save_checkpoint(args.out, ranker_params_to_numpy(ranker), config)
    print(f"wrote {args.out}")
    return {"path": args.out, "groups": len(groups), "losses": losses, "seconds": timer.seconds}


def cmd_rerank_eval(args):
    """Ranker checkpoint + candidate dumps -> re-ranked metrics on the test split."""
    from .config import Config
    from .convert import ranker_params_from_jax
    from .core.checkpoint import load_checkpoint
    from .obs.log import step_timer
    from .rank.pipeline import rerank_eval
    from .rank.ranker import NeuralRanker

    timer = _Seconds()
    config = Config(data_path=args.data_path, user_feature="nc", item_feature="nc")
    with step_timer("load", timer):
        dataset, features = _ranker_inputs(config)
        ranker = NeuralRanker(features)
        ranker_params_from_jax(load_checkpoint(args.ranker)["params"], ranker)
        ranker.to(args.device)
        cands = [np.load(p) for p in args.candidates]
    with step_timer("rerank", timer, trace=True):
        results = rerank_eval(ranker, dataset, cands, dataset.test_dict(), k=args.k)
    print(json.dumps(results, indent=2))
    return {"results": results, "seconds": timer.seconds}


def cmd_preprocess(args):
    """Raw tables -> ID dedup -> categorical / numeric / text / category
    features -> the optional incremental round -> the artifact directory
    and the cf/train.txt / test.txt split."""
    from .obs.log import step_timer
    from .preprocessing.frame import read_table
    from .preprocessing.pipeline import run_preprocessing

    timer = _Seconds()
    with step_timer("read", timer):
        tables = {name: read_table(getattr(args, name)) for name in (
            "products", "customers", "transactions", "product_category", "partner", "reviews")}
    summary = run_preprocessing(
        tables["products"],
        tables["customers"],
        tables["transactions"],
        args.out,
        product_category=tables["product_category"],
        partner=tables["partner"],
        reviews=tables["reviews"],
        suffix=args.suffix,
        incremental_frac=args.incremental_frac,
        test_holdout=args.test_holdout,
        sink=timer,
    )
    print(json.dumps(summary, indent=2))
    return {"summary": summary, "seconds": timer.seconds}


def cmd_convert_recbole(args):
    """An interaction table (k-core filtered when asked) -> RecBole atomic files."""
    from .obs.log import step_timer
    from .preprocessing.filtering import k_core, write_recbole
    from .preprocessing.frame import read_table

    timer = _Seconds()
    with step_timer("read", timer):
        inter = read_table(args.interactions)
        users, items = read_table(args.users), read_table(args.items)
    if args.k_core > 1:
        before = len(inter)
        with step_timer("k_core", timer):
            inter = k_core(inter, args.k_core, item_col=args.item_col, user_col=args.user_col,
                           iterate=args.iterate)
        print(f"k_core({args.k_core}): {before} -> {len(inter)} interactions")
    extra = [c for c in args.extra_inter_cols.split(",") if c]
    dropped = [c for c in inter.columns if c not in (args.user_col, args.item_col, *extra)]
    if dropped:
        print(f"[convert-recbole] dropping interaction columns {dropped} "
              f"(pass --extra_inter_cols to keep them)")
    types = dict(kv.split("=", 1) for kv in args.types.split(",") if kv)
    with step_timer("write", timer):
        written = write_recbole(args.out, args.name, inter, users=users, items=items,
                                item_col=args.item_col, user_col=args.user_col,
                                extra_inter_cols=extra, types=types)
    print(json.dumps(written, indent=2))
    return {"written": written, "rows": len(inter), "seconds": timer.seconds}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="furusato_recommend_tpu_torch.tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump-candidates", help="checkpoint -> top-k dump")
    d.add_argument("--ckpt", required=True)
    d.add_argument("--k", type=int, default=50)
    d.add_argument("--out", default=None)
    d.add_argument("--data_path", default=None)
    d.set_defaults(fn=cmd_dump_candidates)

    e = sub.add_parser("evaluate", help="checkpoint -> metrics")
    e.add_argument("--ckpt", required=True)
    e.add_argument("--data_path", default=None)
    e.add_argument("--save_result", default=None, help="also write per-user CSV")
    e.set_defaults(fn=cmd_evaluate)

    i = sub.add_parser("infer", help="checkpoint -> per-user CSVs over the inference edge set")
    i.add_argument("--ckpt", required=True)
    i.add_argument("--data_path", default=None)
    i.add_argument("--out_dir", default="./data/result")
    i.add_argument("--user_batch", type=int, default=1000)
    i.add_argument(
        "--target_batches",
        default="0",
        help="comma-separated user-batch indices (reference ran 1000,5000,8500)",
    )
    i.add_argument("--k", type=int, default=20)
    i.set_defaults(fn=cmd_infer)

    s = sub.add_parser("recommend", help="online serving one-shot: checkpoint -> top-K per user")
    s.add_argument("--ckpt", required=True)
    s.add_argument("--users", required=True, help="comma-separated user ids")
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--data_path", default=None)
    s.add_argument("--train_edges_only", action="store_true",
                   help="propagate over train edges even if an inference edge set exists")
    s.set_defaults(fn=cmd_recommend)

    t = sub.add_parser("train-ranker", help="candidates -> ranker")
    t.add_argument("--candidates", nargs="+", required=True)
    t.add_argument("--data_path", default="./data")
    t.add_argument("--lgbm_ratio", type=float, default=0.1)
    t.add_argument("--epochs", type=int, default=30)
    t.add_argument("--out", default="./ranker.ckpt")
    t.set_defaults(fn=cmd_train_ranker)

    r = sub.add_parser("rerank-eval", help="candidates -> re-ranked metrics")
    r.add_argument("--candidates", nargs="+", required=True)
    r.add_argument("--ranker", required=True)
    r.add_argument("--data_path", default="./data")
    r.add_argument("--k", type=int, default=10)
    r.set_defaults(fn=cmd_rerank_eval)

    pp = sub.add_parser("preprocess", help="raw tables -> artifact dir")
    pp.add_argument("--products", required=True, help=".csv or .pkl product frame")
    pp.add_argument("--customers", required=True)
    pp.add_argument("--transactions", required=True)
    pp.add_argument("--product_category", default=None)
    pp.add_argument("--partner", default=None)
    pp.add_argument("--reviews", default=None)
    pp.add_argument("--out", required=True, help="artifact directory (becomes --data_path)")
    pp.add_argument("--suffix", default="")
    pp.add_argument("--incremental_frac", type=float, default=0.1,
                    help="fraction of every input pushed through update() after "
                         "initialize (the reference's OFFSET slicing; 0 disables)")
    pp.add_argument("--test_holdout", type=int, default=1,
                    help="last-k interactions per user written to cf/test.txt")
    pp.set_defaults(fn=cmd_preprocess)

    c = sub.add_parser("convert-recbole",
                       help="tables -> RecBole atomic files (optionally k-core filtered first)")
    c.add_argument("--interactions", required=True, help=".csv or .pkl dataframe")
    c.add_argument("--users", default=None)
    c.add_argument("--items", default=None)
    c.add_argument("--out", required=True)
    c.add_argument("--name", default="furusato")
    c.add_argument("--k_core", type=int, default=1, help="5/10 = README five_core/ten_core")
    c.add_argument("--iterate", action="store_true", help="iterate k-core to fixpoint")
    c.add_argument("--user_col", default="customer_id")
    c.add_argument("--item_col", default="remap_id")
    c.add_argument("--extra_inter_cols", default="",
                   help="comma-separated interaction columns to keep beyond "
                        "user/item (e.g. rating,timestamp)")
    c.add_argument("--types", default="",
                   help="col=type overrides, comma-separated; namespace with "
                        "table. for per-table types (e.g. "
                        "timestamp=float,user.timestamp=token)")
    c.set_defaults(fn=cmd_convert_recbole)

    for name, parser in sub.choices.items():
        if name not in _HOST_ONLY:
            parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.cmd not in _HOST_ONLY:
        from .core.device import resolve_device

        args.device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    return args.fn(args)


if __name__ == "__main__":
    main()
