"""The port's elastic plane (sparse_coding_tpu_torch/pipeline/plane.py)
against the JAX package's, on the CPU.

- ``PlaneConfig`` refuses the same configs; ``desired_replicas`` and
  ``Hysteresis`` give the JAX votes on seeded load sequences;
  ``replay_split`` folds the same journals to the same split;
- the arbiter on duck-typed consumers, both packages driven by the same
  scripted load: the same tick breadcrumbs, the same calls to the fleet
  and the gateway in the same order, the same durable records. A tick's
  scale-up reclaims the fleet before it widens the gateway; a scale-down
  drains, then releases the replica on the next tick;
- an arbiter SIGKILLed at the ``plane.rebalance`` barrier (the record
  durable, neither consumer resized): a fresh arbiter's ``reconcile()``
  drives both consumers to the recorded split.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sparse_coding_tpu.pipeline import fleet_queue as jqueue
from sparse_coding_tpu.pipeline import plane as jplane
from sparse_coding_tpu.serve import slo as jslo
from sparse_coding_tpu_torch import obs
from sparse_coding_tpu_torch.pipeline import fleet_queue as tqueue
from sparse_coding_tpu_torch.pipeline import plane as tplane
from sparse_coding_tpu_torch.resilience import crash as tcrash
from sparse_coding_tpu_torch.serve import slo as tslo

REPO = Path(__file__).resolve().parents[1]
SIDES = {"jax": (jplane, jqueue, jslo), "port": (tplane, tqueue, tslo)}
CFG = dict(n_slices=3, replica_slices=1, min_replicas=1, max_replicas=2,
           up_queued_rows=4.0, down_queued_rows=2.0, hold_ticks=2)


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch):
    monkeypatch.delenv(tcrash.ENV_VAR, raising=False)
    monkeypatch.delenv("SPARSE_CODING_FAULT_PLAN", raising=False)
    # the arbiter counts into the process registry: a fresh one a test
    prev = obs.set_registry(obs.Registry())
    yield
    obs.set_registry(prev)


def _signals(slo, queued=0, ewma=0.0, level=0):
    return slo.LoadSignals(queued_rows=queued, queue_depth_ewma=ewma,
                           service_rate_rows_s=None, predicted_wait_s=None,
                           admission_level=level)


def _load_trace(seed: int, n: int = 60) -> list:
    """Seeded load in runs of 1-5 ticks of one regime (idle, between the
    thresholds, busy, browning out), so votes move both ways."""
    rng = np.random.default_rng(seed)
    regimes = ((0, 0.0, 0), (0, 1.0, 0), (3, 3.0, 0), (40, 50.0, 0),
               (10, 1.0, 1))
    out: list = []
    while len(out) < n:
        out += [regimes[int(rng.integers(len(regimes)))]] * int(
            rng.integers(1, 6))
    return out[:n]


# -- pure decision logic ------------------------------------------------------


def test_plane_config_refuses_like_jax():
    for kw in ({"n_slices": 0}, {"n_slices": 2, "min_replicas": 0},
               {"n_slices": 2, "min_replicas": 3},
               {"n_slices": 2, "up_queued_rows": 1.0,
                "down_queued_rows": 2.0},
               {"n_slices": 2, "hold_ticks": 0}):
        with pytest.raises(ValueError) as t:
            tplane.PlaneConfig(**kw)
        with pytest.raises(ValueError) as j:
            jplane.PlaneConfig(**kw)
        assert str(t.value) == str(j.value)
    for kw in ({"n_slices": 5}, {"n_slices": 5, "max_replicas": 2},
               {"n_slices": 7, "replica_slices": 2}):
        t, j = tplane.PlaneConfig(**kw), jplane.PlaneConfig(**kw)
        assert [t.clamp(r) for r in range(-1, 9)] == \
            [j.clamp(r) for r in range(-1, 9)]


@pytest.mark.parametrize("seed", range(4))
def test_votes_and_hysteresis_match_jax(seed):
    cfgs = {s: m[0].PlaneConfig(**CFG) for s, m in SIDES.items()}
    hyst = {s: m[0].Hysteresis(2) for s, m in SIDES.items()}
    current = {"jax": 1, "port": 1}
    trace = []
    for queued, ewma, level in _load_trace(seed):
        row = {}
        for side, (plane, _, slo) in SIDES.items():
            sig = _signals(slo, queued, ewma, level)
            want = plane.desired_replicas(sig, current[side], cfgs[side])
            move = hyst[side].vote(want - current[side])
            current[side] = cfgs[side].clamp(current[side] + move)
            row[side] = (want, move, current[side])
        assert row["port"] == row["jax"]
        trace.append(row["port"][1])
    assert set(trace) >= {-1, 0, 1}  # the traces move both ways


def test_replay_split_matches_jax(tmp_path):
    for side, (plane, queue, _) in SIDES.items():
        q = queue.FleetQueue(tmp_path / side / "fleet_queue.jsonl")
        cfg = plane.PlaneConfig(**CFG)
        assert plane.replay_split(q, cfg) == plane.PlaneSplit(1, 2, 0)
        q.enqueue("r", {"config": {}}, 3)
        for serve in (2, 1, 2):
            q.append(plane.REBALANCE_EVENT, serve_slices=serve,
                     fleet_slices=3 - serve, reason="x")
    t = tplane.replay_split(tqueue.FleetQueue(
        tmp_path / "port" / "fleet_queue.jsonl"), tplane.PlaneConfig(**CFG))
    j = jplane.replay_split(jqueue.FleetQueue(
        tmp_path / "jax" / "fleet_queue.jsonl"), jplane.PlaneConfig(**CFG))
    assert (t.serve_slices, t.fleet_slices, t.seq) == (
        j.serve_slices, j.fleet_slices, j.seq) == (2, 1, 4)
    assert tqueue.FleetQueue(tmp_path / "port" / "fleet_queue.jsonl"
                             ).replay().summary() == {"r": "queued"}


# -- the arbiter on duck-typed consumers --------------------------------------


class _Fleet:
    """Duck-typed FleetScheduler: the plane touches n_slices, queue and
    reclaim_scavengers only."""

    def __init__(self, queue, calls: list):
        self.n_slices = 0
        self.queue = queue
        self.calls = calls

    def reclaim_scavengers(self, max_slices):
        self.calls.append(f"reclaim:{max_slices}")
        return ["scav"] if max_slices == 0 else []


class _Gateway:
    """Duck-typed ServingGateway: replica-count arithmetic only."""

    def __init__(self, calls: list, active=1, spares=1):
        self.active = [f"replica-{i}" for i in range(active)]
        self.spares = [f"spare-{i}" for i in range(spares)]
        self.drained: list = []
        self.calls = calls

    def active_replica_names(self):
        return list(self.active)

    def scale_up(self, n=1):
        got = [self.spares.pop(0) for _ in range(min(n, len(self.spares)))]
        self.active += got
        self.calls.append(f"scale_up:{len(got)}")
        return got

    def scale_down(self, n=1):
        got = []
        while len(got) < n and len(self.active) > 1:
            got.append(self.active.pop())
        self.drained += got
        self.calls.append(f"scale_down:{len(got)}")
        return got

    def reinstate(self, name):
        if name not in self.drained:
            raise ValueError(f"{name} not draining")
        self.drained.remove(name)
        self.spares.append(name)
        self.calls.append(f"reinstate:{name}")


def _drive(tmp_path, side: str, trace: list, seed_up: bool = False):
    plane_mod, queue_mod, slo = SIDES[side]
    calls: list = []
    queue = queue_mod.FleetQueue(tmp_path / side / "fleet_queue.jsonl",
                                 clock=lambda: 0.0)
    fleet = _Fleet(queue, calls)
    gw = _Gateway(calls)
    if seed_up:  # a recorded 2-replica split to shrink
        queue.append(plane_mod.REBALANCE_EVENT, serve_slices=2,
                     fleet_slices=1, reason="up")
        gw.scale_up(1)
    feed = [_signals(slo, *row) for row in trace]
    plane = plane_mod.ElasticPlane(tmp_path / side,
                                   plane_mod.PlaneConfig(**CFG),
                                   gateway=gw, fleet=fleet,
                                   signals_fn=lambda: feed.pop(0))
    ticks = []
    for _ in trace:
        out = plane.tick()
        ticks.append((out["tick"], out["replicas"], out["vote"],
                      out["rebalanced"], out["split"].serve_slices,
                      out["split"].fleet_slices, fleet.n_slices,
                      tuple(gw.active), tuple(gw.drained), tuple(gw.spares)))
    return ticks, calls, queue.path.read_bytes(), plane


def test_scale_up_reclaims_the_fleet_before_widening(tmp_path):
    trace = [(40, 50.0, 0)] * 3
    got = _drive(tmp_path, "port", trace)
    want = _drive(tmp_path, "jax", trace)
    assert got[:3] == want[:3]
    ticks, calls, _, plane = got
    assert not ticks[0][3] and ticks[1][3]  # held one tick, then moved
    assert ticks[1][4:8] == (2, 1, 1, ("replica-0", "spare-0"))
    up = calls.index("scale_up:1")
    assert "reclaim:1" in calls[:up]  # the fleet shrank first
    counters = obs.get_registry().snapshot()["counters"]
    assert (counters["plane.rebalances"], counters["plane.scale_ups"]) == (
        1, 1)
    assert plane.split().serve_slices == 2  # the record is durable


def test_scale_down_drains_then_releases_next_tick(tmp_path):
    trace = [(0, 0.0, 0)] * 4
    got = _drive(tmp_path, "port", trace, seed_up=True)
    want = _drive(tmp_path, "jax", trace, seed_up=True)
    assert got[:3] == want[:3]
    ticks, calls = got[:2]
    assert ticks[1][3] and ticks[1][8] == ("spare-0",)  # drained only
    assert ticks[1][6] == 2  # the freed slice went back to the fleet
    assert ticks[2][8] == () and "spare-0" in ticks[2][9]  # released
    assert calls.index("scale_down:1") < calls.index("reinstate:spare-0")
    assert obs.get_registry().snapshot()["counters"][
        "plane.replicas_released"] == 1


@pytest.mark.parametrize("seed", range(2))
def test_arbiter_matches_jax_on_load_traces(tmp_path, seed):
    trace = _load_trace(seed, 40)
    got = _drive(tmp_path, "port", trace)
    want = _drive(tmp_path, "jax", trace)
    assert got[:3] == want[:3]
    assert any(t[3] for t in got[0])


_KILLED_ARBITER = """
import sys
from sparse_coding_tpu_torch.pipeline.fleet_queue import FleetQueue
from sparse_coding_tpu_torch.pipeline.plane import ElasticPlane, PlaneConfig
from sparse_coding_tpu_torch.serve.slo import LoadSignals

class Fleet:
    def __init__(self, q): self.queue, self.n_slices = q, 2
    def reclaim_scavengers(self, m): raise SystemExit("resized the fleet")

class Gateway:
    def active_replica_names(self): return ["replica-0"]
    def scale_up(self, n): raise SystemExit("resized the gateway")

sig = LoadSignals(queued_rows=50, queue_depth_ewma=50.0,
                  service_rate_rows_s=None, predicted_wait_s=None,
                  admission_level=0)
fleet = Fleet(FleetQueue(sys.argv[1] + "/fleet_queue.jsonl"))
cfg = PlaneConfig(n_slices=3, max_replicas=2, up_queued_rows=4.0,
                  down_queued_rows=2.0, hold_ticks=1)
plane = ElasticPlane(sys.argv[1], cfg, gateway=Gateway(), fleet=fleet,
                     signals_fn=lambda: sig)
plane._release_drained()
split = plane.split()
plane._rebalance(cfg.clamp(plane.target_replicas(split) + 1), sig)
"""


def test_kill_at_rebalance_then_a_fresh_arbiter_reconciles(tmp_path):
    fleet_dir = tmp_path / "fleet"
    fleet_dir.mkdir()
    out = subprocess.run(
        [sys.executable, "-c", _KILLED_ARBITER, str(fleet_dir)], cwd=REPO,
        env={**os.environ, tcrash.ENV_VAR: "plane.rebalance:nth=1",
             "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        capture_output=True, timeout=120)
    assert out.returncode == -9, out.stderr[-2000:]
    queue = tqueue.FleetQueue(fleet_dir / "fleet_queue.jsonl")
    recs = [r for r in queue.journal.records()
            if r["event"] == tplane.REBALANCE_EVENT]
    assert [(r["detail"]["serve_slices"], r["detail"]["fleet_slices"])
            for r in recs] == [(2, 1)]
    calls: list = []
    fleet, gw = _Fleet(queue, calls), _Gateway(calls)
    fleet.n_slices = 2
    plane = tplane.ElasticPlane(fleet_dir, tplane.PlaneConfig(**CFG),
                                gateway=gw, fleet=fleet,
                                signals_fn=lambda: _signals(tslo))
    split = plane.reconcile()
    assert (split.serve_slices, split.fleet_slices) == (2, 1)
    assert fleet.n_slices == 1 and gw.active == ["replica-0", "spare-0"]
    assert calls == ["reclaim:1", "scale_up:1"]
    plane.reconcile()  # idempotent: nothing more to do
    assert calls == ["reclaim:1", "scale_up:1", "reclaim:1"]
    # the JAX arbiter reads the same record to the same split
    j = jplane.replay_split(jqueue.FleetQueue(fleet_dir / "fleet_queue.jsonl"),
                            jplane.PlaneConfig(**CFG))
    assert (j.serve_slices, j.fleet_slices) == (2, 1)
    assert json.loads(queue.path.read_text().splitlines()[-1])["event"] == \
        tplane.REBALANCE_EVENT
