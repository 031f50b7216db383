"""furusato_recommend_tpu_torch — the PyTorch / CUDA port of furusato_recommend_tpu.

The JAX package beside this one is the reference; every module here mirrors the
JAX module of the same path and name, and is held against it by the
``tests/test_torch_*.py`` tests. This package imports torch and numpy only.

Ported so far: the serving path of the MF / LightGCN family — graph build,
full-graph propagation, the fused masked top-k kernel (``ops/streaming_topk.py``
with its CUDA source in ``csrc/``) and the HTTP front end (``serve.py``).

Entry points run on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
