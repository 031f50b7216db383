"""A world of gloo processes on the CPU for the port's multi-device tests.

``run_world(body, world, tmp_path)`` starts ``world`` Python processes, each
of which joins a ``torch.distributed`` world through a ``file://``
rendezvous under ``tmp_path`` (no TCP port, so tests in parallel cannot race
for one), with one CPU thread, then runs ``body`` with ``RANK``, ``WORLD``,
``OUT`` (``tmp_path``) and ``ARGS`` (a JSON value) defined. Each process has
its own timeout, so a hung rendezvous fails the test in seconds; the
processes are killed if any fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PREAMBLE = """
import json, sys, warnings
warnings.filterwarnings("ignore")
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from furusato_recommend_tpu_torch.core.distributed import initialize_multihost, shutdown
RANK, WORLD, OUT, ARGS = int(sys.argv[1]), {world}, {out!r}, json.loads(sys.argv[2])
initialize_multihost(world_size=WORLD, rank=RANK, init_method={init!r}, backend="gloo", timeout_s=60)
try:
{body}
finally:
    shutdown()
"""


def run_world(body: str, world: int, tmp_path, args=None, timeout: float = 120.0) -> list:
    """Run ``body`` on ``world`` ranks; returns each rank's standard output.
    Raises AssertionError with a rank's error output if any fails."""
    init = f"file://{tmp_path}/rendezvous"
    src = _PREAMBLE.format(repo=REPO, world=world, out=str(tmp_path), init=init,
                           body=textwrap.indent(textwrap.dedent(body), "    "))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONWARNINGS="ignore")
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r), json.dumps(args)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} failed ({p.returncode}):\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
