"""The port's ``utils/ops.py`` and its wandb logging against the JAX
package's, on the CPU.

``utils/ops.py``: dotdict, the optional secrets file, the rsync argv of
``sync`` and ``copy_models`` (dry runs: nothing runs, nothing touches a
network) and the S3 calls' ImportError where boto3 does not import.
wandb: a stub module stands in for it (neither package has it here);
``MetricsLogger(use_wandb=True)``, ``basic_l1_sweep`` and ``sweep`` make
the same calls to it as the JAX package's do — init's arguments, each
log's keys and step, finish — and metrics.jsonl is what the run writes
without wandb. The two sweeps train from different inits, so the logged
values are compared with the port's own metrics.jsonl, not with JAX's.
"""

import json
import sys
import types

import numpy as np
import pytest

from sparse_coding_tpu.train.basic_sweep import basic_l1_sweep as jax_basic
from sparse_coding_tpu.train import sweep as jsweep
from sparse_coding_tpu.utils import logging as jlogging
from sparse_coding_tpu.utils import ops as jops
from sparse_coding_tpu_torch.train.basic_sweep import basic_l1_sweep
from sparse_coding_tpu_torch.train import sweep as tsweep
from sparse_coding_tpu_torch.utils import logging as tlogging
from sparse_coding_tpu_torch.utils import ops as tops
from test_torch_port_full_sweep import configs, jax_build, port_build
from test_torch_port_full_sweep import write_store
from torch_port_helpers import batches


class StubWandb(types.ModuleType):
    """A ``wandb`` module that records every call: ("init", kwargs),
    ("log", metrics, step), ("finish",)."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs))
        stub = self

        class Run:
            def log(self, metrics, step=None):
                stub.calls.append(("log", dict(metrics), step))

            def finish(self):
                stub.calls.append(("finish",))

        return Run()


def _records(path) -> list[dict]:
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in path.read_text().splitlines()]


def _shape(calls) -> list:
    """Each call without its logged values: init's arguments, a log's
    keys and step."""
    return [c if c[0] != "log" else ("log", sorted(c[1]), c[2])
            for c in calls]


# --- utils/ops.py ------------------------------------------------------------

def test_dotdict_and_secrets_match_jax(tmp_path):
    for mod in (jops, tops):
        d = mod.dotdict(a=1)
        d.b = 2
        assert (d.a, d.b, d.missing, dict(d)) == (1, 2, None, {"a": 1, "b": 2})
        del d.a
        assert dict(d) == {"b": 2}
        assert mod.load_secrets(tmp_path / "absent.json") == {}
    secrets = tmp_path / "secrets.json"
    secrets.write_text(json.dumps({"wandb_key": "k",
                                   "aws_access_key_id": "i"}))
    assert tops.load_secrets(secrets) == jops.load_secrets(secrets)


@pytest.mark.parametrize("kw", [{}, {"port": 2222},
                                {"excludes": ("a",), "remote_dir": "~/x"}],
                         ids=["default", "port", "excludes"])
def test_dry_run_argv_matches_jax(tmp_path, kw):
    """sync and copy_models build the JAX package's rsync argv and run
    nothing under dry_run; copy_models makes its local folder."""
    sync_kw = dict(kw, local_dir=tmp_path / "tree", dry_run=True)
    assert tops.sync("box", **sync_kw) == jops.sync("box", **sync_kw)
    copy_kw = {k: v for k, v in kw.items() if k == "port"}
    got = tops.copy_models("box", "/r/models", local_dir=tmp_path / "t",
                           dry_run=True, **copy_kw)
    want = jops.copy_models("box", "/r/models", local_dir=tmp_path / "j",
                            dry_run=True, **copy_kw)
    assert got[:-1] == want[:-1] and got[-1] == str(tmp_path / "t") + "/"
    assert (tmp_path / "t").is_dir()


def test_s3_without_boto3_raises_the_jax_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)  # not importable
    f = tmp_path / "f.txt"
    f.write_text("x")
    for mod in (jops, tops):
        with pytest.raises(ImportError, match="boto3 not installed"):
            mod._s3_client({})
        with pytest.raises(ImportError, match="boto3 not installed"):
            mod.upload_to_aws(f, "bucket")
        with pytest.raises(ImportError, match="boto3 not installed"):
            mod.download_from_aws("bucket", "key", tmp_path / "d" / "f")


# --- wandb -------------------------------------------------------------------

def test_metrics_logger_wandb_calls_match_jax(tmp_path, monkeypatch):
    lines = [({"loss": 1.5, "l0": 3.0}, 100), ({"loss": 1.25}, None),
             ({"acts": 7}, 200)]
    calls = {}
    for side, mod in (("jax", jlogging), ("port", tlogging)):
        for wandb in (True, False):
            stub = StubWandb()
            monkeypatch.setitem(sys.modules, "wandb", stub)
            with mod.MetricsLogger(tmp_path / f"{side}_{wandb}",
                                   use_wandb=wandb, run_name="r",
                                   config={"lr": 1e-3}) as logger:
                for metrics, step in lines:
                    logger.log(metrics, step=step)
            calls[side, wandb] = stub.calls
    assert calls["port", True] == calls["jax", True]
    assert calls["port", True][0] == ("init", {
        "project": "sparse_coding_tpu", "name": "r",
        "config": {"lr": 1e-3}})
    assert calls["port", False] == calls["jax", False] == []
    want = _records(tmp_path / "port_False" / "metrics.jsonl")
    assert _records(tmp_path / "port_True" / "metrics.jsonl") == want
    assert _records(tmp_path / "jax_True" / "metrics.jsonl") == want


def test_logger_without_wandb_writes_the_file_alone(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # not importable
    with tlogging.MetricsLogger(tmp_path, use_wandb=True) as logger:
        assert logger.wandb is None
        logger.log({"loss": 1.0}, step=1)
    assert _records(tmp_path / "metrics.jsonl") == [{"step": 1, "loss": 1.0}]


def test_basic_l1_sweep_wandb_calls_match_jax(tmp_path, monkeypatch):
    """104 steps (metrics at step 100): the JAX sweep's init call, its log
    steps and keys, then finish; each logged dict is the port's
    metrics.jsonl line, and that file is the one a run without wandb
    writes (bitwise on the CPU). The port logs every member in one line
    with its mse too, where the JAX sweep logs a line a member, so the
    port's keys at a step hold the JAX lines' keys at that step."""
    d = 16
    from sparse_coding_tpu.data.chunk_store import ChunkWriter

    w = ChunkWriter(tmp_path / "store", d, chunk_size_gb=6656 * d * 2 / 2**30,
                    dtype="float16")
    for b in batches(seed=0, n=52, batch=128, d=d):
        w.add(b)
    w.finalize()
    kw = dict(dict_ratio=2.0, batch_size=64, lr=3e-3, seed=0)
    calls = {}
    for side, wandb in (("jax", True), ("port", True), ("port", False)):
        stub = StubWandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        out = tmp_path / f"{side}_{wandb}"
        if side == "jax":
            jax_basic(tmp_path / "store", out, [1e-3, 1e-2], use_wandb=wandb,
                      **kw)
        else:
            basic_l1_sweep(tmp_path / "store", out, [1e-3, 1e-2],
                           use_wandb=wandb, device="cpu", **kw)
        calls[side, wandb] = stub.calls
    port, jax = calls["port", True], calls["jax", True]
    assert port[0] == jax[0] and port[-1] == jax[-1] == ("finish",)
    assert [c[0] for c in port] == ["init", "log", "finish"]
    jax_keys: dict = {}
    for c in jax[1:-1]:
        jax_keys.setdefault(c[2], set()).update(c[1])
    assert {c[2]: set(c[1]) >= jax_keys[c[2]] for c in port[1:-1]} == {
        step: True for step in jax_keys}
    assert calls["port", False] == []
    logged = [{**({"step": c[2]}), **c[1]} for c in calls["port", True]
              if c[0] == "log"]
    want = _records(tmp_path / "port_False" / "metrics.jsonl")
    assert _records(tmp_path / "port_True" / "metrics.jsonl") == want
    assert logged == want


def test_sweep_wandb_calls_match_jax(tmp_path, monkeypatch):
    """The full sweep (dense_l1_range, 2 chunks) with use_wandb: wandb.init
    with the run name and the config's fields, then the JAX sweep's log
    calls (keys and steps; the throughput lines' values are wall-clock)
    and finish; metrics.jsonl holds each logged line."""
    store = write_store(tmp_path / "store", n_chunks=2)
    jcfg, tcfg = configs(store, tmp_path, use_wandb=True)
    calls = {}
    for side in ("jax", "port"):
        stub = StubWandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        if side == "jax":
            jsweep.sweep(jax_build("dense_l1_range"), jcfg, log_every=5,
                         image_metrics_every=None)
        else:
            tsweep.sweep(port_build("dense_l1_range", jcfg), tcfg,
                         log_every=5, image_metrics_every=None, device="cpu")
        calls[side] = stub.calls
    (_, jinit), (_, tinit) = calls["jax"][0], calls["port"][0]
    assert tinit["project"] == jinit["project"] == "sparse_coding_tpu"
    # the run name is each side's output folder's name
    assert (tinit["name"], jinit["name"]) == ("torch", "jax")
    assert tinit["config"] == tcfg.to_dict()
    assert set(tinit["config"]) == set(jinit["config"])
    assert _shape(calls["port"][1:]) == _shape(calls["jax"][1:])
    assert calls["port"][-1] == ("finish",)
    logged = [{**({"step": c[2]} if c[2] is not None else {}), **c[1]}
              for c in calls["port"] if c[0] == "log"]
    recs = _records(tmp_path / "torch" / "metrics.jsonl")
    assert len(logged) == len(recs) > 1
    for got, rec in zip(logged, recs):
        assert set(got) <= set(rec)
        assert all(rec[k] == v for k, v in got.items()
                   if isinstance(v, (int, float)) and np.isfinite(v))
