"""The port's host→device stage (sparse_coding_tpu_torch/data/ingest.py
``device_batches``, which ``chunk_store.device_prefetch`` is) against the
JAX package's ``data/ingest.py::device_batches`` under the same fault
plans: the ``ingest.transfer`` fault site and its bounded retry, the
lease beat per staged batch and the ``ingest.transfer`` span. On the CPU
the port's stage hands the batches over as tensors; both sides must
deliver the same values in the same order."""

import numpy as np
import pytest

from sparse_coding_tpu import obs as jobs
from sparse_coding_tpu.data.ingest import device_batches as jax_batches
from sparse_coding_tpu.resilience import faults as jfaults
from sparse_coding_tpu.resilience import lease as jlease
from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.data import chunk_store as tcs
from sparse_coding_tpu_torch.data.ingest import device_batches
from sparse_coding_tpu_torch.resilience import faults, lease

D = 8
TRANSIENT = "ingest.transfer:nth=3,error=OSError"
PERSISTENT = "ingest.transfer:nth=2,count=0,error=OSError"


def _batches(n=7):
    rs = np.random.default_rng(3)
    return [rs.normal(size=(4, D)).astype(np.float32) for _ in range(n)]


def _port(batches):
    return [t.numpy() for t in device_batches(iter(batches), "cpu")]


def _jax(batches):
    return [np.asarray(b) for b in jax_batches(iter(batches))]


class _Sinks:
    """A fresh event sink and registry on each side for one block."""

    def __init__(self, tmp_path):
        self.paths = (tmp_path / "port.jsonl", tmp_path / "jax.jsonl")

    def __enter__(self):
        self.sinks = (obs.EventSink(self.paths[0]),
                      jobs.EventSink(self.paths[1]))
        self.prev = (obs.configure_sink(self.sinks[0]),
                     jobs.configure_sink(self.sinks[1]),
                     obs.set_registry(obs.Registry()),
                     jobs.set_registry(jobs.Registry()))
        return self

    def __exit__(self, *exc):
        obs.configure_sink(self.prev[0])
        jobs.configure_sink(self.prev[1])
        obs.set_registry(self.prev[2])
        jobs.set_registry(self.prev[3])
        for s in self.sinks:
            s.close()

    def spans(self, name):
        return ([e for e in obs.read_events(self.paths[0])
                 if e.get("span") == name],
                [e for e in jobs.read_events(self.paths[1])
                 if e.get("span") == name])


@pytest.mark.parametrize("plan", ["", TRANSIENT], ids=["clean", "transient"])
def test_transfers_match_jax_under_the_same_plan(tmp_path, plan):
    """Clean, and with one transient ingest.transfer error (retried): the
    same batches come out in the same order on both sides, the plan fired
    on the same hit, and each side's span counts every batch."""
    batches = _batches()
    with _Sinks(tmp_path) as sinks:
        with faults.inject(*faults.parse_fault_plan(plan).specs) as tp, \
                jfaults.inject(*jfaults.parse_fault_plan(plan).specs) as jp:
            got, ref = _port(batches), _jax(batches)
        port_spans, jax_spans = sinks.spans("ingest.transfer")
    assert len(got) == len(ref) == len(batches)
    for g, r, b in zip(got, ref, batches):
        assert g.tobytes() == r.tobytes() == b.tobytes()
    assert tp.fired == jp.fired == ([("ingest.transfer", 3)] if plan else [])
    assert tp.hits == jp.hits
    assert [e["batches"] for e in port_spans] == [
        e["batches"] for e in jax_spans] == [len(batches)]
    assert port_spans[0]["dur_s"] >= 0


def test_persistent_transfer_fault_raises_after_three_attempts(tmp_path):
    batches = _batches()
    with faults.inject(*faults.parse_fault_plan(PERSISTENT).specs) as tp:
        with pytest.raises(OSError, match="site=ingest.transfer"):
            _port(batches)
    with jfaults.inject(*jfaults.parse_fault_plan(PERSISTENT).specs) as jp:
        with pytest.raises(OSError, match="site=ingest.transfer"):
            _jax(batches)
    # one clean hit, then three attempts at the second batch
    assert tp.hits == jp.hits == {"ingest.transfer": 4}
    assert tp.fired == jp.fired == [("ingest.transfer", n) for n in (2, 3, 4)]


class _CountingLease:
    def __init__(self):
        self.beats = 0

    def beat(self, force=False):
        self.beats += 1


@pytest.mark.parametrize("n", [1, 2, 7])
def test_lease_beats_once_per_staged_batch(n):
    port_lease, jax_lease = _CountingLease(), _CountingLease()
    prev = lease.configure(port_lease), jlease.configure(jax_lease)
    try:
        got, ref = _port(_batches(n)), _jax(_batches(n))
    finally:
        lease.configure(prev[0])
        jlease.configure(prev[1])
    assert len(got) == len(ref) == n
    assert port_lease.beats == jax_lease.beats == n


def test_device_prefetch_is_the_stage_and_an_early_exit_records_its_span(
        tmp_path):
    """chunk_store.device_prefetch is this stage; a consumer that stops
    early still gets the span, counting the batches staged so far."""
    assert tcs.device_prefetch is device_batches
    with _Sinks(tmp_path) as sinks:
        it = device_batches(iter(_batches()), "cpu", buffer_size=2)
        next(it)
        it.close()
        port_spans, _ = sinks.spans("ingest.transfer")
    assert [e["batches"] for e in port_spans] == [3]
