"""Online serving (port of ``serve.py``): checkpoint -> propagated embeddings
kept on the device -> masked top-k per request, behind a stdlib HTTP server.

- ``refresh`` propagates over the inference edge set when the dataset has
  one; the [N, d] / [M, d] embeddings stay on the device.
- ``recommend`` pads each request to a tile, the next power of two of at
  least ``MIN_TILE`` users, with user 0, as the JAX package pads it; each
  tile is one ``masked_topk`` call: the fused score + train-positive mask
  (-1024) + top-k kernel on CUDA, its plain version on the CPU. A row's
  answer depends on its user alone, so the padding changes no real row.

The JAX package's two jitted programs, ``_propagate`` and ``_topk`` (one a
tile and k), have their counterparts on the card: each is captured once as a
CUDA graph and replayed (``core/graphs.py::captured``: a CUDA device; a
Recommender holds no mesh). The CPU runs the same code eagerly.

- The refresh: the first ``refresh`` (the constructor's) is eager, the
  warm-up on the capture stream: cuSPARSE's handle, the tensors the models
  build once and keep (the LightGCN adjacency, the SAGE family's
  mean-aggregation and text-bag matrices), the allocator's blocks. The
  second captures ``model.propagate`` and the float32 copies into the
  graph's own memory pool, then replays; every later ``refresh``,
  ``reload_checkpoint`` and ``POST /reload`` replays it: one graph launch.
  New parameters reach the graph because ``params_from_jax`` copies them in
  place. The graph is dropped when a tensor it reads was replaced rather
  than written in place (``read_tensors``: the model's parameters and
  buffers, the tensors it keeps, the propagation graph's; compared by
  identity against the capture's); that refresh warms up again and the next
  captures anew.
- The requests: one graph a (tile, k). The first request of a shape runs
  eagerly, the second captures. A replay copies the padded ids from pinned
  host memory into the graph's static id tensor, replays the top-k launch
  (the k <= 128 kernel's one launch, or the radix select's), and copies the
  ids and scores, packed into one buffer inside the graph, into pinned host
  memory: the request's one host sync. The request graphs read the
  refresh's outputs: a refresh that makes new ones (eager, or a capture)
  drops them, and a replay, which writes them in place, keeps them.

A failed capture or replay raises; nothing falls back to the eager path. The
top-k kernels are launched through ctypes on the current stream, so a
capture records them; ``ops/streaming_topk.py`` counts a launch under capture
apart, and a replay counts the launches its capture recorded
(``count_replay``). Every call takes the Recommender's ``lock``: the graphs'
static buffers are shared by every caller, the HTTP handler's threads
included.

``Recommender`` runs on the CUDA device unless it is given ``device="cpu"``.
Run the server with ``python -m furusato_recommend_tpu_torch.serve --ckpt ...``.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .convert import params_from_jax
from .core.device import resolve_device
from .core.graphs import captured, new_stats, on_capture_stream, pool_measured
from .data.dataset import Dataset
from .models.base import PairwiseModel
from .ops import streaming_topk
from .ops.streaming_topk import masked_topk

__all__ = ["MIN_TILE", "Recommender", "make_server", "main", "read_tensors", "request_tile", "resolve_device"]

MIN_TILE = 8  # the JAX package's _MIN_TILE
_PACKAGE = __name__.rsplit(".", 1)[0]


def request_tile(n: int) -> int:
    """The tile a request of ``n`` users is padded to: the next power of two
    of at least ``MIN_TILE``."""
    return max(MIN_TILE, 1 << (n - 1).bit_length())


def read_tensors(model: torch.nn.Module, graph) -> List[torch.Tensor]:
    """The tensors a propagation of ``model`` over ``graph`` may read where
    they lie: those in the attributes of the model and its submodules (the
    parameters and buffers, and what the model keeps) and of ``graph``,
    found through dicts, lists, tuples and this package's objects, each
    once, in a fixed order."""
    out: List[torch.Tensor] = []
    seen = set()

    def walk(x, depth: int) -> None:
        if id(x) in seen:
            return
        if isinstance(x, torch.Tensor):
            seen.add(id(x))
            out.append(x)
            return
        if depth == 0 or isinstance(x, torch.nn.Module):
            return
        seen.add(id(x))
        if isinstance(x, dict):
            items = x.values()
        elif isinstance(x, (list, tuple)):
            items = x
        elif type(x).__module__.startswith(_PACKAGE) and hasattr(x, "__dict__"):
            items = vars(x).values()
        else:
            return
        for v in items:
            walk(v, depth - 1)

    for m in model.modules():
        walk(vars(m), 5)
    walk(graph, 5)
    return out


def _same(a: Optional[list], b: Optional[list]) -> bool:
    return a is not None and b is not None and len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _pack(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The ids (int64) and scores (float32) of a tile as one int32 buffer,
    so that one copy takes both to the host."""
    return torch.cat([ids.view(torch.int32).reshape(-1), scores.view(torch.int32).reshape(-1)])


def _unpack(packed: torch.Tensor, tile: int, k: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids [n, k] int64, scores [n, k] float32) of the first n rows of a
    packed tile on the host, copied out of ``packed``."""
    ids = packed[: 2 * tile * k].view(torch.int64).reshape(tile, k)[:n]
    scores = packed[2 * tile * k:].view(torch.float32).reshape(tile, k)[:n]
    return ids.numpy().copy(), scores.numpy().copy()


@dataclasses.dataclass
class _Request:
    """One (tile, k) request program: its static ids on the device and in
    pinned host memory, the packed answer in the graph's pool and in pinned
    host memory, and the graph once captured."""

    ids: torch.Tensor
    host_ids: torch.Tensor
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[torch.Tensor] = None
    host_out: Optional[torch.Tensor] = None
    launches: Tuple[int, int] = (0, 0)  # masked_topk launches a replay adds, and of those the radix select's
    stats: dict = dataclasses.field(default_factory=new_stats)


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
        #: every call holds it: the graphs' static buffers are shared
        self.lock = threading.RLock()
        #: the refresh and the requests are replayed as CUDA graphs (module docstring)
        self.captured = captured(None, self.device)
        self._stream = None  # the capture stream, made at the first refresh
        self.refresh_graph: Optional[torch.cuda.CUDAGraph] = None
        self._refresh_out = None  # the graph's outputs, which each replay overwrites
        self._refresh_reads = None  # read_tensors at the capture
        self._refresh_warm = False  # the eager warm-up has run since the last drop
        #: warm-up, capture and instantiate host ms of the refresh's last
        #: capture, its pool's MiB, its captures and replays
        self.refresh_stats = new_stats()
        #: (tile, k) -> the request program of that shape
        self.requests: Dict[Tuple[int, int], _Request] = {}
        self.refresh(params)

    def _propagate(self):
        with torch.no_grad():
            user_emb, item_emb = self.model.propagate(self._prop_graph)
        return user_emb.detach().float().contiguous(), item_emb.detach().float().contiguous()

    def _serve(self, user_emb: torch.Tensor, item_emb: torch.Tensor) -> None:
        """Serve these embeddings; the request graphs, which read the last
        ones, are dropped."""
        self._user_emb, self._item_emb = user_emb, item_emb
        self.requests.clear()

    def refresh(self, params: Optional[Mapping[str, Any]] = None) -> None:
        """Load ``params`` (if given) and re-propagate once on the device: on
        the card the warm-up, the capture or a replay (module docstring)."""
        with self.lock:
            if params is not None:
                params_from_jax(params, self.model)
            if not self.captured:
                self._serve(*self._propagate())
                return
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if self.refresh_graph is not None and not _same(
                    read_tensors(self.model, self._prop_graph), self._refresh_reads):
                self.refresh_graph = self._refresh_out = self._refresh_reads = None
                self._refresh_warm = False
            if not self._refresh_warm:
                out, self.refresh_stats["warmup_ms"] = on_capture_stream(self._stream, self.device, self._propagate)
                self._refresh_warm = True
                self._serve(*out)
                return
            if self.refresh_graph is None:
                self._capture_refresh()
            self.refresh_graph.replay()
            self.refresh_stats["replays"] += 1
            if self._user_emb is not self._refresh_out[0]:
                self._serve(*self._refresh_out)

    def _capture_refresh(self) -> None:
        """Capture the propagation and its float32 copies into the graph's
        own pool (executing nothing)."""
        with pool_measured(self.device, self.refresh_stats):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                out = self._propagate()
            t1 = time.perf_counter()
            graph.instantiate()
            t2 = time.perf_counter()
        self.refresh_graph, self._refresh_out = graph, out
        self._refresh_reads = read_tensors(self.model, self._prop_graph)
        self.refresh_stats.update(capture_ms=1e3 * (t1 - t0), instantiate_ms=1e3 * (t2 - t1))

    def _answer(self, users: torch.Tensor, k: int) -> torch.Tensor:
        """The packed top-k of a tile of user ids on the device."""
        scores, ids = masked_topk(
            self._user_emb,
            self._item_emb,
            users,
            k,
            None if self._mask is None else self._mask.indptr,
            None if self._mask is None else self._mask.indices,
            sigmoid=self.model.score_sigmoid,
        )
        return _pack(scores, ids)

    def recommend(self, user_ids, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids [n, k], scores [n, k]) for a batch of user ids.

        The request is padded with user 0 to the next power-of-two tile of
        at least ``MIN_TILE`` users, as the JAX package pads it, and only its
        own rows are returned. On the card each (tile, k) is a program of its
        own: its first request eager, its second captured, the rest replays
        (module docstring). Ids outside [0, n_users) raise ``ValueError``
        here, on the host, before anything reaches the device (the kernel
        itself clamps and never checks)."""
        users = np.atleast_1d(np.asarray(user_ids, dtype=np.int64))
        if users.size and (users.min() < 0 or users.max() >= self.n_users):
            raise ValueError(
                f"user ids must be in [0, {self.n_users}), got [{users.min()}, {users.max()}]"
            )
        n = users.shape[0]
        tile = request_tile(n)
        padded = np.zeros(tile, dtype=np.int64)
        padded[:n] = users
        with self.lock:
            req = self.requests.get((tile, k)) if self.captured else None
            if req is None:
                packed = self._answer(torch.from_numpy(padded).to(self.device), k).cpu()
                if self.captured:  # the warm-up of this shape; the next request captures
                    self.requests[(tile, k)] = _Request(
                        ids=torch.empty(tile, dtype=torch.int64, device=self.device),
                        host_ids=torch.empty(tile, dtype=torch.int64, pin_memory=True))
                return _unpack(packed, tile, k, n)
            req.host_ids.numpy()[:] = padded
            req.ids.copy_(req.host_ids, non_blocking=True)
            if req.graph is None:
                self._capture_request(req, k)
            req.graph.replay()
            streaming_topk.count_replay(*req.launches)
            req.stats["replays"] += 1
            req.host_out.copy_(req.out)  # the request's one host sync
            return _unpack(req.host_out, tile, k, n)

    def _capture_request(self, req: _Request, k: int) -> None:
        """Capture the top-k of the static ids and the packing of its answer
        into the graph's own pool (executing nothing)."""
        with pool_measured(self.device, req.stats):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = (streaming_topk.captured, streaming_topk.wide_captured)
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                out = self._answer(req.ids, k)
            t1 = time.perf_counter()
            graph.instantiate()
            t2 = time.perf_counter()
        req.launches = (streaming_topk.captured - before[0], streaming_topk.wide_captured - before[1])
        req.graph, req.out = graph, out
        req.host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        req.stats.update(capture_ms=1e3 * (t1 - t0), instantiate_ms=1e3 * (t2 - t1))

    def reload_checkpoint(self, ckpt_path: str) -> None:
        """Swap in the parameters of a newer checkpoint and re-propagate."""
        from .core.checkpoint import load_checkpoint

        self.refresh(load_checkpoint(ckpt_path)["params"])

    @classmethod
    def from_checkpoint(
        cls, ckpt_path: str, data_path: Optional[str] = None, **kw
    ) -> "Recommender":
        """Build from a checkpoint of ``core.checkpoint.save_checkpoint`` and
        the text dataset (and, for the SAGE family, the feature artifacts;
        for sasrec its item sequences, for asage its attribute graphs:
        ``cli.build_model_inputs``) its config (or ``data_path``) names."""
        from .cli import build_model_inputs
        from .core.checkpoint import load_checkpoint
        from .data.dataset import load_text_dataset
        from .models.registry import build_model

        state = load_checkpoint(ckpt_path)
        config = Config.from_json(json.dumps(state["__config__"]))
        if data_path:
            config = config.replace(data_path=data_path)
        dataset = load_text_dataset(config)
        graph, model_kw = build_model_inputs(config, dataset)
        model = build_model(config.model, config, graph, **model_kw)
        return cls(model, dataset, config, state["params"], **kw)


def make_server(rec: Recommender, host: str = "127.0.0.1", port: int = 8080):
    """JSON-over-HTTP front end:

      GET  /healthz                      -> {"ok": true, ...}
      GET  /recommend?user=3&k=10        -> {"user": 3, "items": [...], "scores": [...]}
      POST /recommend  {"users": [3,17], "k": 10}   -> batch form
      POST /reload     {"ckpt": "path"}  -> swap params + re-propagate

    A ThreadingHTTPServer; device work is serialised behind the
    Recommender's own lock, which its calls take.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

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
