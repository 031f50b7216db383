"""furusato_recommend_tpu_torch — the PyTorch / CUDA port of furusato_recommend_tpu.

The JAX package beside this one is the reference; every module here mirrors the
JAX module of the same path and name, and is held against it by the
``tests/test_torch_*.py`` tests. This package imports torch and numpy only.

Ported so far, for the MF / LightGCN family: the serving path (graph build,
full-graph propagation, the fused masked top-k kernel ``ops/streaming_topk.py``
and the HTTP front end ``serve.py``) and training (the BPR sampler, the
losses, the table gather whose backward is the scatter-add kernel
``ops/scatter.py``, the trainer, the evaluator and ``cli.py``). Each kernel's
CUDA source is in ``csrc/``.

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
