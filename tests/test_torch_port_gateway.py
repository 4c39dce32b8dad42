"""The port's serving gateway, its controllers and the catalog service
(``sparse_coding_tpu_torch/serve/{gateway,health,slo}.py``,
``pipeline/plane.py``, ``catalog/serve.py``) on the CPU.

Against the JAX package's functions and classes on the same scripted
inputs: ``EwmaHealth``, ``AdmissionController``, ``LoadTracker`` and
``Hysteresis`` decisions and snapshots equal; ``request_priority``'s
answers and errors equal; ``CatalogService`` answers over one JAX-built
``CatalogIndex`` against the JAX query functions (``neighbor_topk``,
``union_vote``, ``feature_stats``) with the service's filter (dead
features and the self-match out): cosines within 1e-6, features equal but
at near-ties within it, votes equal. Within the port: results bitwise
equal across replicas (one program table), failover with every request
answered, a hedged first-wins request, zero captures on spare activation
and after warmup, and a ladder swap that captures only its new rungs.
Every threaded wait carries its own timeout.
"""

import numpy as np
import pytest
import torch

from sparse_coding_tpu.serve import health as jhealth
from sparse_coding_tpu.serve import slo as jslo
from sparse_coding_tpu_torch import obs, xcache
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.obs.registry import Registry
from sparse_coding_tpu_torch.pipeline.plane import Hysteresis
from sparse_coding_tpu_torch.resilience import crash, faults
from sparse_coding_tpu_torch.serve import (
    BATCH,
    INTERACTIVE,
    PRIORITIES,
    SCAVENGER,
    AdmissionController,
    CircuitOpenError,
    EwmaHealth,
    ModelRegistry,
    QueueFullError,
    ServingEngine,
    ServingGateway,
)
from sparse_coding_tpu_torch.serve import slo as tslo

D, N = 16, 32
BUCKETS = (4, 8, 16)
TIMEOUT = 30.0
COS_TOL = 1e-6


@pytest.fixture(autouse=True)
def isolated():
    """No fault or crash plan, a fresh process registry and no warm cache
    per test; all restored after."""
    prev_plans = faults.install_plan(None), crash.install_crash_plan(None)
    prev_reg = obs.set_registry(Registry())
    yield
    xcache.disable()
    obs.set_registry(prev_reg)
    faults.install_plan(prev_plans[0])
    crash.install_crash_plan(prev_plans[1])


def _dict(seed: int) -> tld.UntiedSAE:
    r = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(r.normal(size=s).astype(np.float32))
    return tld.UntiedSAE(encoder=t(N, D), encoder_bias=0.3 * t(N),
                         dictionary=t(N, D))


def _registry() -> ModelRegistry:
    reg = ModelRegistry(device="cpu")
    reg.register("m", _dict(0))
    reg.register_stack("s", [_dict(1), _dict(2)])
    return reg


def _payloads(n: int, seed: int = 1, max_rows: int = 8) -> list:
    r = np.random.default_rng(seed)
    return [r.normal(size=(int(k), D)).astype(np.float32)
            for k in r.integers(1, max_rows + 1, n)]


def _gateway(reg, **kw) -> ServingGateway:
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("ops", ("encode", "vote"))
    kw.setdefault("max_wait_ms", 0.0)
    return ServingGateway(reg, device="cpu", **kw)


def _direct(reg, model, payloads) -> list:
    """Each payload's encode through a lone engine (its own program
    table): the reference every replica's bits must equal."""
    with ServingEngine(reg, buckets=BUCKETS, ops=("encode",),
                       device="cpu") as eng:
        eng.warmup()
        return [eng.query(model, x, timeout=TIMEOUT) for x in payloads]


# -- the controllers against the JAX package ----------------------------------


def test_health_scores_match_jax():
    outcomes = [(0.01, True), (0.2, False), (0.0, True), (0.05, True),
                (1.5, False), (0.003, True)] * 3
    snaps = []
    for cls in (jhealth.EwmaHealth, EwmaHealth):
        h = cls(alpha=0.3, latency_scale_s=0.02)
        seq = []
        for dur, ok in outcomes:
            h.record(dur, ok)
            seq.append((h.score, h.observations))
        snaps.append((seq, h.snapshot()))
    assert snaps[0] == snaps[1]
    for cls in (jhealth.EwmaHealth, EwmaHealth):
        with pytest.raises(ValueError):
            cls(alpha=0.0)


def _admission_script(ctl, mod):
    """A scripted p99 stream and admissions at each level: the levels
    and each admit's outcome (its shed message)."""
    log = []
    p99s = [None, 50, 250, 250, 250, 250, 10, 10, 10, 10, 400, 400, 400,
            400, 400, 400, 400, 400, 20, 20, 20, 20, 20, 20, 20, 20]
    for p in p99s:
        log.append(("level", ctl.observe_p99(p)))
        for prio in mod.PRIORITIES:
            for queued, wait, deadline in ((0, None, None), (600, 0.5, 1.0),
                                           (900, 2.0, 1.0)):
                try:
                    ctl.admit(prio, deadline, queued_rows=queued,
                              max_queue_rows=1000, predicted_wait_s=wait)
                    log.append(("admit", prio))
                except mod.QueueFullError as e:
                    log.append(("shed", prio, str(e), e.retry_after_s))
    ctl.set_level(2)
    log.append(("snapshot", ctl.snapshot()))
    with pytest.raises(ValueError) as e:
        ctl.admit("urgent", None, 0, 10, None)
    log.append(str(e.value))
    return log


def test_admission_controller_matches_jax():
    logs = [_admission_script(
        mod.AdmissionController(target_p99_ms=100.0, adjust_every=4), mod)
        for mod in (jslo, tslo)]
    assert logs[0] == logs[1]
    sheds = {e[1] for e in logs[1] if isinstance(e, tuple) and e[0] == "shed"}
    assert sheds == set(PRIORITIES)


def test_load_tracker_and_priorities_match_jax():
    seqs = []
    for mod in (jslo, tslo):
        t = mod.LoadTracker(alpha=0.25)
        seq = [t.snapshot()]
        for q, rate, wait, level in ((0, None, None, 0), (40, 100.0, 0.4, 1),
                                     (10, 120.0, 0.1, 0), (300, 80.0, 3.7, 2)):
            seq.append(t.observe(q, rate, wait, level, active_max_rows=64))
        seqs.append([s.__dict__ for s in seq])
        seqs[-1].append([mod.priority_rank(p) for p in mod.PRIORITIES])
        seqs[-1].append(mod.windowed_quantile([3.0, 1.0, 2.0, 5.0], 0.75))
    assert seqs[0] == seqs[1]
    assert tslo.PRIORITIES == jslo.PRIORITIES


def test_hysteresis_matches_jax():
    from sparse_coding_tpu.pipeline.plane import Hysteresis as JHysteresis

    votes = [1, 1, 0, 1, 1, 1, -1, -1, 1, -1, -1, -1, 0, 5, 5, -3]
    for hold in (1, 2, 3):
        j, t = JHysteresis(hold), Hysteresis(hold)
        assert [t.vote(v) for v in votes] == [j.vote(v) for v in votes]


def test_request_priority_matches_jax():
    from sparse_coding_tpu.catalog import serve as jserve
    from sparse_coding_tpu_torch.catalog import serve as tserve

    assert tserve.REQUEST_CLASSES == jserve.REQUEST_CLASSES
    for cls in jserve.REQUEST_CLASSES:
        assert tserve.request_priority(cls) == jserve.request_priority(cls)
    errs = []
    for mod in (jserve, tserve):
        with pytest.raises(ValueError) as e:
            mod.request_priority("feature.nope")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the gateway within the port ---------------------------------------------


def test_pool_results_bitwise_and_zero_captures_after_warmup():
    """Mixed traffic through 2 replicas sharing one program table: every
    result bitwise the lone engine's, each (model, op, bucket) captured
    once for the whole pool, none after warmup."""
    reg = _registry()
    payloads = _payloads(20)
    want = _direct(reg, "m", payloads)
    captures = obs.counter("xcache.captures")
    before = captures.value
    with _gateway(reg, n_replicas=2, n_spares=1) as gw:
        n = gw.warmup()
        # m: encode; s: encode and vote; 3 buckets; once for the pool
        assert n == captures.value - before == 9
        got = [gw.query("m", p, priority=PRIORITIES[i % 3], timeout=TIMEOUT)
               for i, p in enumerate(payloads)]
        votes = gw.query("s", payloads[0], op="vote", timeout=TIMEOUT)
        snap = gw.stats()
    assert captures.value == before + n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    assert votes.shape == (payloads[0].shape[0], N)
    assert snap["recompiles"] == 0
    assert all(r["recompiles"] == 0 for r in snap["replicas"].values())
    assert sum(snap["gateway"]["served"].values()) == 21
    assert snap["gateway"]["shed"] == {p: 0 for p in PRIORITIES}
    assert snap["replicas"]["spare-0"]["state"] == "spare"


def test_failover_answers_every_request_and_spare_activates_at_zero_captures(
        monkeypatch):
    """replica-0's backend dies: its breaker opens on the first failure,
    the flush fails over (no request lost, bits unchanged), and the spare
    activates from the manifest through the shared table: 0 captures."""
    reg = _registry()
    payloads = _payloads(12, seed=3)
    want = _direct(reg, "m", payloads)
    with _gateway(reg, n_replicas=2, n_spares=1, breaker_threshold=1,
                  breaker_reset_s=3600.0, hedge_after_s=3600.0) as gw:
        gw.warmup()
        dead = gw.replica("replica-0")
        for _ in range(20):
            dead.health.record(0.0, ok=True)  # rank it primary

        def boom(model, op, x):
            raise OSError("replica backend died")

        monkeypatch.setattr(dead.engine, "run_padded", boom)
        captures = obs.counter("xcache.captures").value
        got = [gw.query("m", p, timeout=TIMEOUT) for p in payloads]
        snap = gw.stats()
        assert obs.counter("xcache.captures").value == captures
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    r = snap["replicas"]
    assert r["replica-0"]["breaker"]["state"] == "open"
    assert r["replica-0"]["breaker"]["transitions"] == ["closed->open"]
    assert r["replica-0"]["state"] == "draining"
    assert r["spare-0"]["state"] == "active"
    g = snap["gateway"]
    assert g["spare_activations"] == 1 and g["failovers"] >= 1
    assert g["replica_errors"]["replica-0"] == 1
    assert snap["request_errors"] == {}


def test_serve_dispatch_fault_trips_one_replica():
    """The serve.dispatch fault plan fails the primary's first replay;
    the flush fails over and the spare replaces the tripped replica."""
    reg = _registry()
    with _gateway(reg, n_replicas=2, n_spares=1, breaker_threshold=1,
                  breaker_reset_s=3600.0, hedge_after_s=3600.0) as gw:
        gw.warmup()
        with faults.inject(site="serve.dispatch", nth=1, count=1) as plan:
            outs = [gw.query("m", p, timeout=TIMEOUT)
                    for p in _payloads(5, seed=4)]
        snap = gw.stats()
    assert plan.fired == [("serve.dispatch", 1)]
    assert all(o.shape[1] == N for o in outs)
    states = {n: r["state"] for n, r in snap["replicas"].items()}
    assert sorted(states.values()) == ["active", "active", "draining"]
    assert snap["gateway"]["spare_activations"] == 1
    assert snap["request_errors"] == {}


def test_every_replica_open_sheds_with_circuit_open():
    reg = _registry()
    with _gateway(reg, n_replicas=1, n_spares=0, breaker_threshold=1,
                  breaker_reset_s=3600.0) as gw:
        gw.warmup()
        gw.replica("replica-0").breaker.record_failure()
        with pytest.raises(CircuitOpenError):
            gw.submit("m", _payloads(1)[0])
        assert gw.stats()["gateway"]["shed"][BATCH] == 1


def test_hedged_request_first_wins():
    """hedge_after_s=0 hedges every flush at the other replica: results
    stay bitwise, and each fired hedge is counted once as won or
    wasted."""
    reg = _registry()
    payloads = _payloads(10, seed=5)
    want = _direct(reg, "m", payloads)
    with _gateway(reg, n_replicas=2, n_spares=0, hedge_after_s=0.0) as gw:
        gw.warmup()
        got = [gw.query("m", p, timeout=TIMEOUT) for p in payloads]
        g = gw.stats()["gateway"]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert g["hedges_fired"] >= 1
    assert g["hedges_won"] + g["hedges_wasted"] == g["hedges_fired"]
    assert g["hedges_abandoned"] == 0


def test_hung_replica_times_out_and_fails_over(monkeypatch):
    import threading

    reg = _registry()
    release = threading.Event()
    with _gateway(reg, n_replicas=2, n_spares=1, breaker_threshold=1,
                  breaker_reset_s=3600.0, hedge_after_s=3600.0,
                  dispatch_timeout_s=0.3) as gw:
        gw.warmup()
        hung = gw.replica("replica-0")
        for _ in range(20):
            hung.health.record(0.0, ok=True)
        real = hung.engine.run_padded

        def wedge(model, op, x):
            release.wait(timeout=TIMEOUT)
            return real(model, op, x)

        monkeypatch.setattr(hung.engine, "run_padded", wedge)
        try:
            out = gw.query("m", np.zeros((2, D), np.float32),
                           timeout=TIMEOUT)
            snap = gw.stats()
        finally:
            release.set()
    assert out.shape == (2, N)
    assert snap["gateway"]["dispatch_timeouts"]["replica-0"] == 1
    assert snap["replicas"]["replica-0"]["state"] == "draining"
    assert snap["replicas"]["spare-0"]["state"] == "active"


def test_admission_sheds_scavenger_first_and_on_deadline():
    reg = _registry()
    admission = AdmissionController(target_p99_ms=1e9)
    with _gateway(reg, n_replicas=1, n_spares=0,
                  admission=admission) as gw:
        gw.warmup()
        gw.query("m", _payloads(1)[0], timeout=TIMEOUT)
        admission.set_level(1)
        with pytest.raises(QueueFullError):
            gw.submit("m", _payloads(1)[0], priority=SCAVENGER)
        gw.query("m", _payloads(1)[0], priority=INTERACTIVE, timeout=TIMEOUT)
        admission.set_level(0)
        gw.pause()
        gw.submit("m", _payloads(1, max_rows=16)[0])
        with pytest.raises(QueueFullError):
            gw.submit("m", _payloads(1)[0], deadline_s=0.0)
        gw.resume()
        g = gw.stats()["gateway"]
    assert g["shed"][SCAVENGER] == 1 and g["shed"][INTERACTIVE] == 0


def test_ladder_swap_captures_only_the_new_rungs(monkeypatch):
    """A derived ladder held through the flap guard, then swapped:
    captures equal the new rungs' programs and nothing more; the pin
    overrides derivation; later traffic captures nothing."""
    reg = _registry()
    captures = obs.counter("xcache.captures")
    r = np.random.default_rng(6)
    with _gateway(reg, n_replicas=2, n_spares=1, ladder_hold_ticks=2,
                  ladder_max_rungs=2, ladder_align=4) as gw:
        gw.warmup()
        # 10-row requests (the histogram's (8, 12] bin) and a few of 16:
        # the derived ladder is (12, 16)
        for rows in [10] * 24 + [16] * 4:
            gw.query("m", r.normal(size=(rows, D)).astype(np.float32),
                     timeout=TIMEOUT)
        assert gw.maybe_swap_ladder() is None  # held one tick
        before = captures.value
        swap = gw.maybe_swap_ladder()
        assert swap is not None and swap["source"] == "derived"
        assert swap["rungs"] == (12, 16)
        # the new rung 12: m's encode, s's encode and vote
        assert swap["programs_warmed"] == 3
        assert captures.value - before == swap["programs_warmed"]
        assert gw.active_buckets == swap["rungs"]
        for p in _payloads(6, seed=7, max_rows=12):
            gw.query("m", p, timeout=TIMEOUT)
        monkeypatch.setenv("SPARSE_CODING_LADDER_PIN", "4,16")
        pinned = gw.maybe_swap_ladder()
        snap = gw.stats()
    assert pinned["source"] == "pin" and pinned["rungs"] == (4, 16)
    assert pinned["programs_warmed"] == 0  # both rungs already captured
    assert snap["recompiles"] == 0
    assert snap["gateway"]["ladder"]["swaps"] == 2


def test_scale_up_down_and_reinstate():
    reg = _registry()
    captures = obs.counter("xcache.captures")
    with _gateway(reg, n_replicas=1, n_spares=2) as gw:
        gw.warmup()
        before = captures.value
        assert gw.scale_up(2) == ["spare-0", "spare-1"]
        assert captures.value == before
        assert len(gw.active_replica_names()) == 3
        drained = gw.scale_down(5)
        assert len(drained) == 2 and len(gw.active_replica_names()) == 1
        gw.reinstate(drained[0])
        assert gw.replica(drained[0]).state == "spare"
        sig = gw.load_signals()
    assert sig.active_max_rows == BUCKETS[-1] and sig.ticks == 1


def test_gateway_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingGateway(ModelRegistry(device="cpu"))


# -- the catalog service against the JAX query functions ---------------------


@pytest.fixture(scope="module")
def jax_catalog(tmp_path_factory):
    """A JAX-written artifact set and store, and the JAX package's
    catalog build over them."""
    import jax.numpy as jnp

    from sparse_coding_tpu.catalog import build as jbuild
    from sparse_coding_tpu.data.chunk_store import ChunkWriter
    from sparse_coding_tpu.models.learned_dict import TiedSAE as JTiedSAE
    from sparse_coding_tpu.utils.artifacts import save_learned_dicts

    base = tmp_path_factory.mktemp("gateway_catalog")
    r = np.random.default_rng(0)
    w = ChunkWriter(base / "chunks", D, chunk_size_gb=D * 128 * 4 / 2**30,
                    dtype="float32")
    w.add(r.normal(size=(256, D)).astype(np.float32))
    w.finalize()
    dicts = []
    for seed in (1, 2, 3):
        rr = np.random.default_rng(seed)
        d = rr.normal(size=(N, D)).astype(np.float32)
        bias = (rr.normal(size=(N,)) * 0.1).astype(np.float32)
        if seed == 1:
            bias[7] = -1000.0  # never fires: dead
            d[5] = d[3]  # a planted neighbor tie
        dicts.append((JTiedSAE(dictionary=jnp.asarray(d),
                               encoder_bias=jnp.asarray(bias)),
                      {"l1_alpha": 1e-3 * seed}))
    pkl = base / "learned_dicts.pkl"
    save_learned_dicts(dicts, pkl)
    jbuild.build_catalog(pkl, base / "chunks", base / "cat", experiment="t")
    return base


def _jax_hits(jld, q, k_engine, want, dead, exclude):
    """The JAX query function's top-k, filtered as the service filters
    (dead features and the self-match out)."""
    import jax.numpy as jnp

    from sparse_coding_tpu.catalog import query as jquery

    vals, idx = jquery.unpack_neighbors(
        jquery.neighbor_topk(jld, jnp.asarray(q)[None], k_engine))
    out = []
    for cos, f in zip(vals[0].tolist(), idx[0].tolist()):
        if f == exclude or dead[f]:
            continue
        out.append({"feature": int(f), "cos": float(cos)})
        if len(out) >= want:
            break
    return out


def _assert_hits(got, ref, rows):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert abs(a["cos"] - b["cos"]) <= COS_TOL
        if a["feature"] != b["feature"]:
            assert abs(rows[a["feature"]] - rows[b["feature"]]) <= COS_TOL


def test_catalog_service_matches_jax_query_functions(jax_catalog):
    import jax.numpy as jnp

    from sparse_coding_tpu.catalog import build as jbuild
    from sparse_coding_tpu.catalog import query as jquery
    from sparse_coding_tpu.utils import trees as jtrees
    from sparse_coding_tpu.utils.artifacts import (
        load_learned_dicts as jload,
    )
    from sparse_coding_tpu_torch.catalog import CatalogIndex, CatalogService
    from sparse_coding_tpu_torch.serve import CATALOG_OPS

    jindex = jbuild.CatalogIndex.load(jax_catalog / "cat", verify=True)
    index = CatalogIndex.load(jax_catalog / "cat", verify=True)
    reg = ModelRegistry(device="cpu")
    names = reg.load_native(jax_catalog / "learned_dicts.pkl", prefix="cat")
    jdicts = [ld for ld, _ in jload(jax_catalog / "learned_dicts.pkl")]
    reg.register_stack("stack", [reg.get(n).tree for n in names])
    k = 6
    with _gateway(reg, n_replicas=1, n_spares=0, ops=CATALOG_OPS,
                  engine_kwargs={"topk_k": k}) as gw:
        gw.warmup()
        svc = CatalogService(index, gw, names, stack_model="stack")
        for f in (3, 5, 7, 11):
            assert svc.stats(0, f) == jindex.feature_stats(0, f)
            got = svc.neighbors(0, f, k=4)
            ref = _jax_hits(jdicts[0], index.rows(0)[f], k, 4,
                            jindex.dead(0), exclude=f)
            _assert_hits(got, ref, index.rows(0)[f] @ index.rows(0).T)
        r = np.random.default_rng(9)
        q = r.normal(size=(3, D)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        for got, qq in zip(svc.search(1, q), q):
            ref = _jax_hits(jdicts[1], qq, k, k, jindex.dead(1),
                            exclude=None)
            _assert_hits(got, ref, qq @ index.rows(1).T)
        x = r.normal(size=(5, D)).astype(np.float32)
        union = svc.union(x, quorum=2)
        with pytest.raises(ValueError):
            CatalogService(index, gw, names[:2])
        assert svc.neighbors(0, 3, k=4)[0]["feature"] == 5  # planted tie
    votes = np.asarray(jquery.union_vote(jtrees.stack_trees(jdicts),
                                         jnp.asarray(x)))
    np.testing.assert_array_equal(union, votes >= 2)
