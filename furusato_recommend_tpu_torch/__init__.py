"""furusato_recommend_tpu_torch — the PyTorch / CUDA port of furusato_recommend_tpu.

The JAX package beside this one is the reference; every module here mirrors the
JAX module of the same path and name, and is held against it by the
``tests/test_torch_*.py`` tests. This package imports torch and numpy only.

Ported so far: for the MF / LightGCN family, the serving path (graph build,
full-graph propagation, the fused masked top-k kernel ``ops/streaming_topk.py``
and the HTTP front end ``serve.py``) and training (the BPR sampler, the
losses, the table gather whose backward is the scatter-add kernel
``ops/scatter.py``, the trainer, the evaluator and ``cli.py``); for the SAGE
family (``models/sage.py``), serving and training with the ddp recipe, the
trainer's cadences of the cached feature tables and the out-of-core ``dask``
variant (``data/ooc.py``); the checkpoint tools (``tools.py``); the two-stage
ranker (``rank/``: candidate dumps through the masked top-k, the neural
LambdaRank re-ranker whose embedding gradient goes through the scatter-add).
Each kernel's CUDA source is in ``csrc/``.

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
