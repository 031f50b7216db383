"""Port vs JAX package: the metric sinks and the profiler (``obs/log.py``,
``obs/profiler.py``) on the CPU.

The JSONL records equal the JAX logger's but for their timestamps; both
loggers make the same calls on a stub ``wandb`` module and print the same
notice when ``wandb.init`` raises; the tensorboard scalars read back from
the event file are the logged ones (float32, as the event file keeps them).
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from furusato_recommend_tpu.obs import log as jlog
from furusato_recommend_tpu.obs import profiler as jprofiler
from furusato_recommend_tpu_torch.obs import log as tlog
from furusato_recommend_tpu_torch.obs import profiler as tprofiler

torch.set_num_threads(1)

RECORDS = [
    ({"loss": 0.6931, "samples_per_sec": 1234.5}, 1),
    ({"recall@10": 0.125, "ndcg@10": 0.0625}, 3),
    ({"time/epoch": 2.5}, None),
    ({"loss": 0.5}, 7),
    ({"coverage@10": 0.75}, None),
]


def _log_all(logger):
    for metrics, step in RECORDS:
        logger.log(metrics, step=step)
    logger.close()


def _records(path):
    out = []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            assert isinstance(r.pop("ts"), float)
            out.append(r)
    return out


def test_jsonl_records_equal_jax(tmp_path, capsys):
    _log_all(jlog.MetricLogger(jsonl_path=tmp_path / "j" / "m.jsonl"))
    jax_out = capsys.readouterr().out
    _log_all(tlog.MetricLogger(jsonl_path=tmp_path / "t" / "m.jsonl"))
    assert capsys.readouterr().out == jax_out  # the stdout lines too
    assert _records(tmp_path / "t" / "m.jsonl") == _records(tmp_path / "j" / "m.jsonl")
    assert len(_records(tmp_path / "t" / "m.jsonl")) == len(RECORDS)


def test_step_timer_logs_seconds(tmp_path):
    got = {}
    for mod in (jlog, tlog):
        p = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        lg = mod.MetricLogger(jsonl_path=p, quiet=True)
        with mod.step_timer("epoch", lg):
            torch.ones(64).sum()
        with mod.step_timer("eval", lg, trace=True):
            pass
        with mod.step_timer("unlogged"):
            pass
        lg.close()
        got[mod] = _records(p)
    for mod, recs in got.items():
        assert [list(r) for r in recs] == [["time/epoch"], ["time/eval"]], mod
        assert all(0.0 <= v < 5.0 for r in recs for v in r.values())


class _WandbStub:
    def __init__(self, fail=False):
        self.calls = []
        self.fail = fail

    def module(self):
        stub = types.ModuleType("wandb")
        calls, fail = self.calls, self.fail

        class Run:
            def log(self, payload, step=None):
                calls.append(("log", dict(payload), step))

            def finish(self):
                calls.append(("finish",))

        def init(project=None, name=None):
            calls.append(("init", project, name))
            if fail:
                raise RuntimeError("no network")
            return Run()

        stub.init = init
        return stub


def test_wandb_sink_calls_equal_jax(monkeypatch):
    seen = {}
    for mod in (jlog, tlog):
        stub = _WandbStub()
        monkeypatch.setitem(sys.modules, "wandb", stub.module())
        _log_all(mod.MetricLogger(wandb_run="run-a", project="proj", quiet=True))
        seen[mod] = stub.calls
    assert seen[tlog] == seen[jlog]
    assert seen[tlog][0] == ("init", "proj", "run-a") and seen[tlog][-1] == ("finish",)
    assert [c[2] for c in seen[tlog] if c[0] == "log"] == [s for _, s in RECORDS]


@pytest.mark.parametrize("how", ["init_raises", "module_missing"])
def test_wandb_falls_back_with_the_jax_notice(tmp_path, monkeypatch, capsys, how):
    outs, records = {}, {}
    for mod in (jlog, tlog):
        if how == "init_raises":
            monkeypatch.setitem(sys.modules, "wandb", _WandbStub(fail=True).module())
        else:
            monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
        p = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        lg = mod.MetricLogger(jsonl_path=p, wandb_run="run-b", quiet=True)
        outs[mod] = capsys.readouterr().out
        _log_all(lg)
        records[mod] = _records(p)
    assert outs[tlog] == outs[jlog]
    assert outs[tlog].startswith("[obs] wandb unavailable (") and "falling back to jsonl/stdout" in outs[tlog]
    assert records[tlog] == records[jlog]


def test_tensorboard_scalars_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    _log_all(tlog.MetricLogger(tensorboard_dir=tmp_path / "tb", quiet=True))
    ea = EventAccumulator(str(tmp_path / "tb"))
    ea.Reload()
    # the JAX rule: a record without a step takes the one after the last
    want = {}
    nxt = 0
    for metrics, step in RECORDS:
        s = step if step is not None else nxt
        nxt = s + 1
        for k, v in metrics.items():
            want.setdefault(k, []).append((s, np.float32(v)))
    assert sorted(ea.Tags()["scalars"]) == sorted(want)
    for k, pts in want.items():
        assert [(e.step, np.float32(e.value)) for e in ea.Scalars(k)] == pts, k


def test_tensorboard_missing_falls_back(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = tlog.MetricLogger(jsonl_path=tmp_path / "m.jsonl", tensorboard_dir=tmp_path / "tb", quiet=True)
    out = capsys.readouterr().out
    assert out.startswith("[obs] tensorboard unavailable (") and "falling back to jsonl/stdout" in out
    _log_all(lg)
    assert len(_records(tmp_path / "m.jsonl")) == len(RECORDS)
    assert not (tmp_path / "tb").exists()


def test_device_memory_stats_empty_on_the_cpu():
    assert jprofiler.device_memory_stats() == {}  # the JAX CPU backend has no stats
    assert tprofiler.device_memory_stats("cpu") == {}
    assert tprofiler.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert tprofiler.device_memory_stats() == {}

    class Sink:
        logged = []

        def log(self, m, step=None):
            self.logged.append(m)

    assert tprofiler.log_device_memory(Sink(), device="cpu") == {} and Sink.logged == []


def test_trace_writes_a_chrome_trace_naming_its_operations(tmp_path):
    a = torch.randn(32, 16)
    with tprofiler.trace(tmp_path / "tr") as prof:
        with tlog.step_timer("infer/topk", trace=True):
            torch.mm(a, a.T)
    assert prof is not None
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::mm" in names and "infer/topk" in names
