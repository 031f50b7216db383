"""Online serving (port of ``serve.py``): checkpoint -> propagated embeddings
kept on the device -> masked top-k per request, behind a stdlib HTTP server.

- Full-graph propagation runs once, in ``refresh``, over the inference edge
  set when the dataset has one; the [N, d] / [M, d] embeddings stay on the
  device.
- Each request is one ``masked_topk`` call: the fused score + train-positive
  mask (-1024) + top-k kernel on CUDA, its plain version on the CPU.

``Recommender`` runs on the CUDA device unless it is given ``device="cpu"``.
Run the server with ``python -m furusato_recommend_tpu_torch.serve --ckpt ...``.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .convert import params_from_jax
from .core.device import resolve_device
from .data.dataset import Dataset
from .models.base import PairwiseModel
from .ops.streaming_topk import masked_topk

__all__ = ["Recommender", "make_server", "main", "resolve_device"]


class Recommender:
    def __init__(
        self,
        model: PairwiseModel,
        dataset: Dataset,
        config: Config,
        params: Optional[Mapping[str, Any]],
        use_inference_edges: bool = True,
        exclude_train: bool = True,
        device=None,
    ):
        """``params``: name -> array (the JAX package's parameter dict, as
        numpy), or None to serve the model's own parameters."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.n_users = dataset.n_users
        self.m_items = dataset.m_items
        # train positives are the exclusion source
        self._mask = dataset.graph.user_pos.to(self.device) if exclude_train else None
        prop = (
            dataset.inference_graph
            if use_inference_edges and dataset.has_inference_edges
            else dataset.graph
        )
        self._prop_graph = prop.to(self.device)
        self.refresh(params)

    def refresh(self, params: Optional[Mapping[str, Any]] = None) -> None:
        """Load ``params`` (if given) and re-propagate once on the device."""
        if params is not None:
            params_from_jax(params, self.model)
        with torch.no_grad():
            user_emb, item_emb = self.model.propagate(self._prop_graph)
        self._user_emb = user_emb.detach().float().contiguous()
        self._item_emb = item_emb.detach().float().contiguous()

    def recommend(self, user_ids, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids [n, k], scores [n, k]) for a batch of user ids.

        The JAX package pads each request to a power-of-two tile to bound its
        compile cache; nothing here compiles per shape and padding changes no
        result, so a request runs at its own size. Ids outside [0, n_users)
        raise ``ValueError`` here, on the host, before anything reaches the
        device (the kernel itself clamps and never checks)."""
        users = np.atleast_1d(np.asarray(user_ids, dtype=np.int64))
        if users.size and (users.min() < 0 or users.max() >= self.n_users):
            raise ValueError(
                f"user ids must be in [0, {self.n_users}), got [{users.min()}, {users.max()}]"
            )
        scores, ids = masked_topk(
            self._user_emb,
            self._item_emb,
            torch.from_numpy(users).to(self.device),
            k,
            None if self._mask is None else self._mask.indptr,
            None if self._mask is None else self._mask.indices,
            sigmoid=self.model.score_sigmoid,
        )
        return ids.cpu().numpy(), scores.cpu().numpy()

    def reload_checkpoint(self, ckpt_path: str) -> None:
        """Swap in the parameters of a newer checkpoint and re-propagate."""
        from .core.checkpoint import load_checkpoint

        self.refresh(load_checkpoint(ckpt_path)["params"])

    @classmethod
    def from_checkpoint(
        cls, ckpt_path: str, data_path: Optional[str] = None, **kw
    ) -> "Recommender":
        """Build from a checkpoint of ``core.checkpoint.save_checkpoint`` and
        the text dataset its config (or ``data_path``) names."""
        from .core.checkpoint import load_checkpoint
        from .data.dataset import load_text_dataset
        from .models.registry import build_model

        state = load_checkpoint(ckpt_path)
        config = Config.from_json(json.dumps(state["__config__"]))
        if data_path:
            config = config.replace(data_path=data_path)
        dataset = load_text_dataset(config)
        model = build_model(config.model, config, dataset.graph)
        return cls(model, dataset, config, state["params"], **kw)


def make_server(rec: Recommender, host: str = "127.0.0.1", port: int = 8080):
    """JSON-over-HTTP front end:

      GET  /healthz                      -> {"ok": true, ...}
      GET  /recommend?user=3&k=10        -> {"user": 3, "items": [...], "scores": [...]}
      POST /recommend  {"users": [3,17], "k": 10}   -> batch form
      POST /reload     {"ckpt": "path"}  -> swap params + re-propagate

    A ThreadingHTTPServer; device work is serialised behind one lock.
    """
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/healthz":
                return self._send(
                    200,
                    {
                        "ok": True,
                        "n_users": int(rec.n_users),
                        "m_items": int(rec.m_items),
                        "model": rec.config.model,
                    },
                )
            if u.path == "/recommend":
                q = parse_qs(u.query)
                try:
                    users = [int(x) for x in q["user"]]
                    k = int(q.get("k", ["10"])[0])
                except (KeyError, ValueError):
                    return self._send(400, {"error": "need ?user=<id>[&k=N]"})
                if any(not 0 <= x < rec.n_users for x in users):
                    return self._send(400, {"error": "user id out of range"})
                try:
                    with lock:
                        ids, scores = rec.recommend(users, k=k)
                except ValueError as e:  # k out of range
                    return self._send(400, {"error": str(e)})
                out = [
                    {"user": u_, "items": i.tolist(),
                     "scores": [round(float(s), 5) for s in sc]}
                    for u_, i, sc in zip(users, ids, scores)
                ]
                return self._send(200, out[0] if len(out) == 1 else out)
            return self._send(404, {"error": "unknown path"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                return self._send(400, {"error": "bad json"})
            if not isinstance(payload, dict):
                return self._send(400, {"error": "need a JSON object"})
            if self.path == "/recommend":
                users = payload.get("users")
                try:
                    users = [int(x) for x in users] if isinstance(users, list) else []
                    k = int(payload.get("k", 10))
                except (TypeError, ValueError):
                    users = []
                if not users:
                    return self._send(400, {"error": "need {'users': [ids], 'k': N}"})
                if any(not 0 <= x < rec.n_users for x in users):
                    return self._send(400, {"error": "user id out of range"})
                try:
                    with lock:
                        ids, scores = rec.recommend(users, k=k)
                except ValueError as e:  # k out of range
                    return self._send(400, {"error": str(e)})
                return self._send(
                    200,
                    [
                        {"user": int(u_), "items": i.tolist(),
                         "scores": [round(float(s), 5) for s in sc]}
                        for u_, i, sc in zip(users, ids, scores)
                    ],
                )
            if self.path == "/reload":
                ckpt = payload.get("ckpt")
                if not ckpt:
                    return self._send(400, {"error": "need {'ckpt': path}"})
                try:
                    with lock:
                        rec.reload_checkpoint(ckpt)
                except Exception as e:  # report load errors to the operator
                    return self._send(500, {"error": str(e)})
                return self._send(200, {"ok": True})
            return self._send(404, {"error": "unknown path"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="furusato_recommend_tpu_torch.serve")
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--train_edges_only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = Recommender.from_checkpoint(
        args.ckpt,
        data_path=args.data_path,
        use_inference_edges=not args.train_edges_only,
        device=args.device,
    )
    srv = make_server(rec, args.host, args.port)
    print(f"serving on http://{args.host}:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
