"""The port's serving engine, registry, batching, metrics, ladder and warm
cache (``sparse_coding_tpu_torch/serve``, ``xcache``) against the JAX
package's functions on the same seeded numpy inputs, on the CPU.

The oracles are the JAX package's functions and classes (``bucket_op_fn``
and ``build_bucket_program``, ``prepare_request``, the ladder solver,
``ServingMetrics``, ``ModelRegistry``, ``jax.lax.top_k``), never its
serving test files. Tolerances: op results within rtol 1e-5 of max|ref|
(the JAX programs run the same products under XLA), top-k indices equal
but at near-ties within that bound; ladder bytes, metric snapshots and
error messages equal. Within the port: coalescing, backpressure, the
breaker opening and healing, zero captures after warmup and the warm set
taken from the manifest. Every threaded wait carries its own timeout.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding_tpu.models import learned_dict as jld
from sparse_coding_tpu.obs.registry import Registry as JRegistry
from sparse_coding_tpu.serve import engine as jengine
from sparse_coding_tpu.serve import ladder as jladder
from sparse_coding_tpu.serve import metrics as jmetrics
from sparse_coding_tpu.serve import registry as jregistry
from sparse_coding_tpu.utils.artifacts import save_learned_dicts
from sparse_coding_tpu_torch import obs, xcache
from sparse_coding_tpu_torch.catalog.query import (
    neighbor_topk,
    neighbor_topk_plain,
    top_k,
)
from sparse_coding_tpu_torch.models import learned_dict as tld
from sparse_coding_tpu_torch.obs.registry import Registry
from sparse_coding_tpu_torch.resilience import crash, faults
from sparse_coding_tpu_torch.resilience.breaker import CircuitBreaker
from sparse_coding_tpu_torch.serve import (
    CATALOG_OPS,
    DEFAULT_OPS,
    CircuitOpenError,
    ModelRegistry,
    QueueFullError,
    RequestTooLargeError,
    ServingEngine,
    score_offline,
)
from sparse_coding_tpu_torch.serve import engine as tengine
from sparse_coding_tpu_torch.serve import ladder as tladder
from sparse_coding_tpu_torch.serve import metrics as tmetrics

D, N, N_STACK = 16, 32, 3
BUCKETS = (4, 8, 16)
OPS = DEFAULT_OPS + ("predict",) + CATALOG_OPS
K = 5
RTOL = 1e-5
TIMEOUT = 30.0


@pytest.fixture(autouse=True)
def isolated():
    """Each test runs with no fault or crash plan, a fresh process
    registry and no warm cache, and restores them after."""
    prev_plans = faults.install_plan(None), crash.install_crash_plan(None)
    prev_reg = obs.set_registry(Registry())
    yield
    xcache.disable()
    obs.set_registry(prev_reg)
    faults.install_plan(prev_plans[0])
    crash.install_crash_plan(prev_plans[1])


def _arrays(seed: int, n: int = N, d: int = D) -> dict:
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return {"dictionary": f32(r.normal(size=(n, d))),
            "encoder": f32(r.normal(size=(n, d))),
            "encoder_bias": f32(0.3 * r.normal(size=(n,)))}


def _untied(a, jax_side: bool):
    if jax_side:
        return jld.UntiedSAE(**{k: jnp.asarray(v) for k, v in a.items()})
    return tld.UntiedSAE(**{k: torch.from_numpy(v) for k, v in a.items()})


def _tied(a, jax_side: bool):
    kw = {"dictionary": a["dictionary"], "encoder_bias": a["encoder_bias"]}
    if jax_side:
        return jld.TiedSAE(**{k: jnp.asarray(v) for k, v in kw.items()})
    return tld.TiedSAE(**{k: torch.from_numpy(v) for k, v in kw.items()})


def _registries():
    """The same dicts in both packages' registries: ``single`` (untied)
    and ``stack`` (three tied)."""
    jreg, treg = jregistry.ModelRegistry(), ModelRegistry(device="cpu")
    for reg, side in ((jreg, True), (treg, False)):
        reg.register("single", _untied(_arrays(0), side))
        reg.register_stack("stack", [_tied(_arrays(10 + i), side)
                                     for i in range(N_STACK)])
    return jreg, treg


def _payload(seed: int, op: str, rows: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    if op == "decode":
        return np.asarray(r.uniform(size=(rows, N))
                          * (r.uniform(size=(rows, N)) < 0.3), np.float32)
    x = np.asarray(r.normal(size=(rows, D)), np.float32)
    if op == "neighbors":
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x


def _jax_op(jreg, model, op, x, bucket):
    """The JAX package's bucket program on ``x`` zero-padded to
    ``bucket``, cut to the request rows, as host arrays."""
    entry = jreg.get(model)
    fn, spec = jengine.build_bucket_program(entry, op, bucket, jnp.float32,
                                            K)
    padded = np.zeros(spec.shape, np.float32)
    padded[:x.shape[0]] = x
    out = jax.jit(fn)(entry.tree, jnp.asarray(padded))
    axis = jengine.op_rows_axis(entry, op)
    sl = (slice(None),) * axis + (slice(0, x.shape[0]),)
    return tuple(np.asarray(o)[sl] for o in (
        out if isinstance(out, tuple) else (out,)))


def _assert_close(got, ref, label):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, f"{label}: {err} > {RTOL} * {scale}"


def _near_ties(got_idx, ref_idx, score, bound, label):
    for pos in zip(*np.nonzero(got_idx != ref_idx)):
        row = score[pos[:-1]]
        assert abs(row[got_idx[pos]] - row[ref_idx[pos]]) <= bound, \
            f"{label}: {pos} is no near-tie"


@pytest.mark.parametrize("model,op", [
    (m, op) for m in ("single", "stack") for op in OPS
    if op != "vote" or m == "stack"])
def test_engine_results_match_jax_bucket_programs(model, op):
    """Every op through the port's engine (queue, coalescing, padded
    bucket) against the JAX package's bucket program at the same bucket:
    within rtol 1e-5 of max|ref|, indices equal but at near-ties."""
    jreg, treg = _registries()
    x = _payload(1, op, 6)
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, topk_k=K,
                       device="cpu") as eng:
        eng.warmup()
        got = eng.query(model, x, op=op, timeout=TIMEOUT)
        assert eng.stats()["recompiles"] == 0
    got = got if isinstance(got, tuple) else (got,)
    ref = _jax_op(jreg, model, op, x, bucket=8)
    assert [g.shape for g in got] == [r.shape for r in ref]
    label = f"{model}/{op}"
    if op == "topk":
        _assert_close(got[0], ref[0], label)
        codes = _jax_op(jreg, model, "encode", x, bucket=8)[0]
        _near_ties(got[1], ref[1], codes, RTOL * np.abs(codes).max(), label)
    elif op == "neighbors":
        _assert_close(got[0][..., :K], ref[0][..., :K], label)
        entry = jreg.get(model)
        sims = np.asarray(jax.vmap(lambda ld: x @ ld.get_learned_dict().T)(
            entry.tree) if entry.is_stack
            else x @ np.asarray(entry.tree.get_learned_dict()).T)
        _near_ties(got[0][..., K:].astype(np.int32),
                   ref[0][..., K:].astype(np.int32), sims,
                   RTOL * np.abs(sims).max(), label)
    elif op == "vote":
        np.testing.assert_array_equal(got[0], ref[0])
    else:
        _assert_close(got[0], ref[0], label)


def test_offline_scorer_and_bucket_padding_match_jax():
    """score_offline over 37 rows (slabs of 16, the tail padded into 8)
    against the JAX bucket programs on the same slabs."""
    jreg, treg = _registries()
    x = _payload(2, "encode", 37)
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, topk_k=K,
                       device="cpu") as eng:
        eng.warmup()
        got = score_offline(eng, "stack", x, op="topk")
        assert eng.stats()["recompiles"] == 0
    assert got[0].shape == (N_STACK, 37, K)
    for start, bucket in ((0, 16), (16, 16), (32, 8)):
        ref = _jax_op(jreg, "stack", "topk", x[start:start + 16], bucket)
        _assert_close(got[0][:, start:start + 16], ref[0], "offline")


_REQUESTS = {
    "op not served": ("single", "predict", np.zeros((2, D))),
    "vote on a single dict": ("single", "vote", np.zeros((2, D))),
    "3-D payload": ("single", "encode", np.zeros((2, 2, D))),
    "wrong width": ("single", "encode", np.zeros((2, D + 1))),
    "decode width": ("stack", "decode", np.zeros((2, D))),
    "empty": ("single", "encode", np.zeros((0, D))),
    "too large": ("single", "encode", np.zeros((17, D))),
}


@pytest.mark.parametrize("case", sorted(_REQUESTS))
def test_prepare_request_errors_match_jax(case):
    """The submit-time contract: each bad request raises the JAX
    package's error type with its message."""
    model, op, x = _REQUESTS[case]
    jreg, treg = _registries()
    errs = []
    for mod, reg in ((jengine, jreg), (tengine, treg)):
        with pytest.raises(Exception) as e:
            mod.prepare_request(reg.get(model), op, DEFAULT_OPS + ("vote",),
                                BUCKETS, np.float32, x)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    if case == "too large":
        assert errs[1][0] == RequestTooLargeError.__name__


def test_prepare_request_canonicalizes_like_jax():
    jreg, treg = _registries()
    x = np.arange(D, dtype=np.float64)
    j = jengine.prepare_request(jreg.get("single"), "encode", DEFAULT_OPS,
                                BUCKETS, np.float32, x)
    t = tengine.prepare_request(treg.get("single"), "encode", DEFAULT_OPS,
                                BUCKETS, np.float32, x)
    assert t[1:] == j[1:] == (1, True)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[0].dtype == np.float32


def _record(metrics):
    """One recorded serving sequence (queue, batches, latencies, errors,
    breaker) for both packages' ServingMetrics."""
    for rows in (1, 3, 5, 7, 9, 13, 30, 70, 100, 700, 3000):
        metrics.record_enqueue(rows)
    metrics.record_dequeue(40)
    metrics.record_reject()
    for bucket, n, rows, flush in ((8, 2, 7, False), (64, 3, 50, True),
                                   (512, 1, 300, False), (8, 1, 8, True)):
        metrics.record_batch(bucket, n, rows, flush)
    for bucket, s in ((8, 0.002), (8, 0.004), (64, 0.01), (512, 0.03),
                      (8, 0.0015)):
        metrics.record_latency(bucket, s)
    metrics.record_rebatch(2, 9, rejected=1)
    metrics.record_rebatch(0, 0, rejected=1)
    metrics.record_recompile(("m", "encode", 64))
    metrics.record_request_errors(3, "DispatchError")
    metrics.record_dispatch_retry()
    metrics.record_dispatch_failure()
    metrics.record_shed(2)
    metrics.record_breaker_transition("closed", "open")
    metrics.record_breaker_transition("open", "half_open")


def test_metrics_snapshot_and_ladder_bytes_match_jax():
    """The same recorded sequence: equal ServingMetrics snapshots, equal
    snapshot bytes (digest included), the same derived ladder and the
    same canonical ladder JSON, byte for byte, at several solver
    settings."""
    jm = jmetrics.ServingMetrics(registry=JRegistry())
    tm = tmetrics.ServingMetrics(registry=Registry())
    _record(jm)
    _record(tm)
    assert tm.snapshot() == jm.snapshot()
    jraw, traw = jladder.snapshot_bytes(jm.registry), \
        tladder.snapshot_bytes(tm.registry)
    assert traw == jraw
    snap = tladder.parse_snapshot(traw)
    assert snap == jladder.parse_snapshot(jraw)
    for kw in ({}, {"max_rungs": 2}, {"max_rungs": 6, "align": 4},
               {"min_rung": 32}):
        j, t = jladder.derive_ladder(snap, **kw), tladder.derive_ladder(
            snap, **kw)
        assert tladder.ladder_to_json(t) == jladder.ladder_to_json(j)
        assert tladder.ladder_pad_rows(snap, t["rungs"]) == \
            jladder.ladder_pad_rows(snap, j["rungs"])
    empty = tladder.traffic_snapshot(Registry())
    assert tladder.ladder_to_json(tladder.derive_ladder(empty)) == \
        jladder.ladder_to_json(jladder.derive_ladder(
            jladder.traffic_snapshot(JRegistry())))
    corrupt = bytearray(traw)
    corrupt[len(corrupt) // 2] ^= 1
    with pytest.raises(tladder.SnapshotIntegrityError):
        tladder.parse_snapshot(bytes(corrupt))


@pytest.mark.parametrize("pin", ["", "8,24,96", " 4, 8 ,512", "8,8",
                                 "16,8", "0,8", "a,b", ","])
def test_pinned_ladder_parses_like_jax(pin):
    assert tladder.PIN_ENV == jladder.PIN_ENV
    outcomes = []
    for mod in (jladder, tladder):
        try:
            outcomes.append(("ok", mod.pinned_ladder({mod.PIN_ENV: pin})))
        except mod.LadderError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_pinned_ladder_reads_the_environment(monkeypatch):
    monkeypatch.setenv(jladder.PIN_ENV, "8,32")
    assert tladder.pinned_ladder() == jladder.pinned_ladder() == (8, 32)


def _breaker_script(breaker, clock):
    """A scripted sequence of admissions and outcomes: the returned
    tokens (probe tokens as "probe"), states and snapshots."""
    log = []

    def allow():
        tok = breaker.allow()
        log.append(("allow", tok if isinstance(tok, bool) else "probe",
                    breaker.state))
        return tok

    stale = allow()
    for _ in range(2):
        breaker.record_failure(allow())
        log.append(("failure", breaker.state, breaker.admission_allowed()))
    log.append(("cooldown", breaker.seconds_until_probe()))
    clock[0] += 4.0
    log.append(("early", breaker.admission_allowed(), allow()))
    clock[0] += 2.0
    probe = allow()
    allow()  # a second probe is refused
    breaker.record_success(stale)  # a raced stale success cannot heal
    log.append(("stale", breaker.state))
    breaker.record_failure(probe)  # the probe fails: open again
    log.append(("probe failed", breaker.state))
    clock[0] += 5.0
    probe = allow()
    breaker.record_success(probe)
    log.append(("healed", breaker.state, breaker.snapshot()))
    return log


def test_breaker_matches_jax_over_a_scripted_clock():
    from sparse_coding_tpu.resilience.breaker import (
        CircuitBreaker as JBreaker,
    )

    logs = []
    for cls in (JBreaker, CircuitBreaker):
        clock = [100.0]
        transitions = []
        b = cls(failure_threshold=2, reset_timeout_s=5.0,
                clock=lambda: clock[0],
                on_transition=lambda o, n: transitions.append((o, n)))
        logs.append((_breaker_script(b, clock), transitions))
    assert logs[0] == logs[1]
    assert logs[1][1] == [("closed", "open"), ("open", "half_open"),
                          ("half_open", "open"), ("open", "half_open"),
                          ("half_open", "closed")]


def test_breaker_opens_and_heals_in_the_engine():
    """Two failed flushes (a non-transient injected error) open the
    engine's breaker: submit sheds with CircuitOpenError; past the
    cooldown the half-open probe succeeds and the circuit closes."""
    _, treg = _registries()
    clock = [0.0]
    breaker = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
                             clock=lambda: clock[0])
    x = _payload(3, "encode", 2)
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, breaker=breaker,
                       max_wait_ms=0.0, device="cpu") as eng:
        eng.warmup()
        with faults.inject(site="serve.dispatch", count=2,
                           error="RuntimeError"):
            for _ in range(2):
                with pytest.raises(Exception, match="injected"):
                    eng.query("single", x, timeout=TIMEOUT)
        assert breaker.state == "open"
        with pytest.raises(CircuitOpenError):
            eng.submit("single", x)
        clock[0] += 10.0
        out = eng.query("single", x, timeout=TIMEOUT)
        snap = eng.stats()
    assert out.shape == (2, N)
    assert breaker.state == "closed"
    assert snap["breaker_transitions"] == ["closed->open", "open->half_open",
                                           "half_open->closed"]
    assert snap["dispatch_failures"] == 2 and snap["shed_requests"] == 1


def test_transient_dispatch_error_retries_within_budget():
    _, treg = _registries()
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, max_wait_ms=0.0,
                       retry_backoff_s=0.0, device="cpu") as eng:
        eng.warmup()
        with faults.inject(site="serve.dispatch", count=2, error="OSError"):
            out = eng.query("single", _payload(4, "encode", 3),
                            timeout=TIMEOUT)
        snap = eng.stats()
    assert out.shape == (3, N)
    assert snap["dispatch_retries"] == 2 and snap["dispatch_failures"] == 0


def test_coalescing_into_one_bucket_and_deadline_flush():
    """Paused, four requests of one stream queue; resumed, they leave in
    one flush of bucket 16 and each result equals its own rows of a
    direct query; a lone request flushes at its deadline into bucket 4."""
    _, treg = _registries()
    xs = [_payload(10 + i, "encode", r) for i, r in enumerate((3, 4, 2, 5))]
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, max_wait_ms=1.0,
                       device="cpu") as eng:
        eng.warmup()
        eng.pause()
        futs = [eng.submit("stack", x, op="encode") for x in xs]
        assert eng.metrics.queued_rows == 14
        eng.resume()
        got = [f.result(timeout=TIMEOUT) for f in futs]
        lone = eng.query("stack", xs[0], op="encode", timeout=TIMEOUT)
        snap = eng.stats()
    assert snap["buckets"][16]["batches"] == 1
    assert snap["buckets"][16]["requests"] == 4
    assert snap["buckets"][4]["deadline_flushes"] == 1
    assert snap["recompiles"] == 0
    for g, x in zip(got, xs):
        assert g.shape == (N_STACK, x.shape[0], N)
    np.testing.assert_allclose(lone, got[0], rtol=0, atol=1e-5)


def test_backpressure_rejects_past_the_queue_cap():
    _, treg = _registries()
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, max_queue_rows=10,
                       device="cpu") as eng:
        eng.warmup()
        eng.pause()
        fut = eng.submit("single", _payload(5, "encode", 8))
        with pytest.raises(QueueFullError) as e:
            eng.submit("single", _payload(6, "encode", 3))
        assert (e.value.queued_rows, e.value.max_queue_rows) == (8, 10)
        eng.resume()
        assert fut.result(timeout=TIMEOUT).shape == (8, N)
        assert eng.stats()["rejected"] == 1


def test_warmup_captures_each_program_once_and_none_after(tmp_path):
    """warmup captures every (model, op, bucket) program (vote on the
    stack only) and records each in the manifest; traffic on every
    program and a second warmup capture nothing; a program first asked
    for after warmup counts as a recompile."""
    _, treg = _registries()
    cache = xcache.enable(tmp_path / "xc")
    captures = obs.counter("xcache.captures")
    with ServingEngine(treg, buckets=BUCKETS, ops=OPS, topk_k=K,
                       device="cpu") as eng:
        n = eng.warmup()
        assert n == captures.value == 2 * len(OPS) * 3 - 3
        assert len(cache.warmup.descriptors(kind="serve")) == n
        for model in ("single", "stack"):
            for op in OPS:
                if op == "vote" and model == "single":
                    continue
                for rows in (1, 5, 16):
                    eng.query(model, _payload(rows, op, rows), op=op,
                              timeout=TIMEOUT)
        assert eng.warmup() == 0
        assert captures.value == n and eng.stats()["recompiles"] == 0
        treg.register("late", _untied(_arrays(7), False))
        eng.query("late", _payload(8, "encode", 2), timeout=TIMEOUT)
        snap = eng.stats()
    assert snap["recompiles"] == 1
    assert snap["recompile_keys"] == [("late", "encode", 4)]


def test_warmup_from_manifest_takes_the_recorded_set(tmp_path):
    """A restarted engine captures exactly the manifest's programs (a
    foreign model's descriptor skipped) and serves them with no further
    capture; a manifest naming nothing it serves falls back to the full
    warmup."""
    _, treg = _registries()
    cache = xcache.enable(tmp_path / "xc")
    with ServingEngine(treg, buckets=BUCKETS, ops=("encode", "topk"),
                       device="cpu") as eng:
        eng.warmup()
        eng.set_buckets((4, 8))  # a shrink keeps 16 in the known set
    cache.warmup.record({"kind": "serve", "model": "gone", "op": "encode",
                         "bucket": 4, "dtype": "float32", "stack": False})
    recorded = {(d["model"], d["op"], d["bucket"])
                for d in cache.warmup.descriptors(kind="serve")}
    assert len(recorded) == 2 * 2 * 3 + 1
    captures = obs.counter("xcache.captures")
    before = captures.value
    with ServingEngine(treg, buckets=BUCKETS, ops=("encode", "topk"),
                       device="cpu") as eng2:
        n = eng2.warmup_from_manifest()
        table = set(eng2.program_cache.compiled)
        eng2.query("stack", _payload(9, "encode", 3), timeout=TIMEOUT)
        assert eng2.stats()["recompiles"] == 0
    assert n == captures.value - before == 12
    assert table == recorded - {("gone", "encode", 4)}
    foreign = xcache.WarmupManifest(tmp_path / "foreign.json")
    foreign.record({"kind": "serve", "model": "gone", "op": "encode",
                    "bucket": 4})
    with ServingEngine(treg, buckets=(4,), ops=("encode",),
                       device="cpu") as eng3:
        assert eng3.warmup_from_manifest(foreign) == 2
    data = json.loads((tmp_path / "xc" / "warmup.json").read_text())
    assert all(v["kind"] == "serve" for v in data.values())


def test_program_key_names_descriptor_and_environment():
    a = {"kind": "serve", "model": "m", "op": "encode", "bucket": 8}
    assert xcache.program_key(a) == xcache.program_key(dict(a))
    assert xcache.program_key(a) != xcache.program_key(dict(a, bucket=64))
    assert xcache.program_key(a) != xcache.program_key(a, extra="salt")


def test_registry_loads_a_jax_written_artifact(tmp_path):
    """load_native of a learned_dicts.pkl the JAX package wrote (with a
    hyperparams filter): the same names, hyperparams and encodes as the
    JAX registry's."""
    pairs = [(_untied(_arrays(20), True), {"l1_alpha": 1e-3}),
             (_tied(_arrays(21), True), {"l1_alpha": 3e-3}),
             (_untied(_arrays(22), True), {"l1_alpha": 1e-2})]
    path = tmp_path / "learned_dicts.pkl"
    save_learned_dicts(pairs, path)
    select = lambda h: h["l1_alpha"] < 5e-3
    jreg, treg = jregistry.ModelRegistry(), ModelRegistry(device="cpu")
    names = treg.load_native(path, prefix="sweep", select=select)
    assert names == jreg.load_native(path, prefix="sweep", select=select)
    x = _payload(23, "encode", 4)
    for name in names:
        je, te = jreg.get(name), treg.get(name)
        assert (te.cls_name, te.d_activation, te.n_feats, te.hyperparams) \
            == (je.cls_name, je.d_activation, je.n_feats, je.hyperparams)
        _assert_close(te.tree.encode(torch.from_numpy(x)).numpy(),
                      np.asarray(je.tree.encode(jnp.asarray(x))), name)
        assert te.tree.get_learned_dict().device.type == "cpu"


def test_registry_loads_a_reference_pt(tmp_path):
    from test_ref_interop import _ref_instance, _save_ref_artifact

    r = np.random.default_rng(30)
    enc, dec = (r.normal(size=(24, D)).astype(np.float32) for _ in "ab")
    bias = r.normal(size=(24,)).astype(np.float32)
    ref = _ref_instance("UntiedSAE", encoder=torch.tensor(enc),
                        decoder=torch.tensor(dec),
                        encoder_bias=torch.tensor(bias), n_feats=24,
                        activation_size=D)
    path = _save_ref_artifact(tmp_path, [(ref, {"l1_alpha": 1e-3})])
    jreg, treg = jregistry.ModelRegistry(), ModelRegistry(device="cpu")
    names = treg.load_reference(path, prefix="ref")
    assert names == jreg.load_reference(path, prefix="ref") == ["ref/0"]
    x = _payload(31, "encode", 5)
    for fn in ("encode", "predict"):
        _assert_close(getattr(treg.get("ref/0").tree, fn)(
            torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jreg.get("ref/0").tree, fn)(jnp.asarray(x))),
            fn)


def test_registry_rejections_match_jax():
    """AddedNoise (batch-coupled), a non-dict, a duplicate name and
    inhomogeneous stacks: the JAX registry's error types and messages."""
    jreg, treg = jregistry.ModelRegistry(), ModelRegistry(device="cpu")
    jnoise = jld.AddedNoise.create(jax.random.PRNGKey(0), D, 0.1)
    tnoise = tld.AddedNoise.create(torch.Generator().manual_seed(0), D, 0.1)
    small = {k: v[:N // 2] for k, v in _arrays(41).items()}
    cases = [
        lambda reg, side: reg.register("noise",
                                       jnoise if side else tnoise),
        lambda reg, side: reg.register("arr", np.zeros((N, D))),
        lambda reg, side: (reg.register("dup", _tied(_arrays(1), side)),
                           reg.register("dup", _tied(_arrays(2), side))),
        lambda reg, side: reg.register_stack(
            "mixed", [_tied(_arrays(1), side), _untied(_arrays(2), side)]),
        lambda reg, side: reg.register_stack(
            "shapes", [_tied(_arrays(1), side), _tied(small, side)]),
        lambda reg, side: reg.register_stack("empty", []),
    ]
    for case in cases:
        errs = []
        for reg, side in ((jreg, True), (treg, False)):
            with pytest.raises(Exception) as e:
                case(reg, side)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]


def test_registry_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ModelRegistry().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(ModelRegistry(device="cpu"))
    with pytest.raises(NotImplementedError, match="item 17"):
        ServingEngine(ModelRegistry(device="cpu"), mesh=object(),
                      device="cpu")


def test_top_k_matches_lax_top_k_on_planted_ties_and_signed_zeros():
    """torch.topk on packed order keys against jax.lax.top_k: planted
    ties, +0.0 beside -0.0, infinities, subnormals, all-equal rows and
    all-negative rows; values bitwise, indices equal; the stable-sort
    plain version equal too."""
    r = np.random.default_rng(50)
    v = r.normal(size=(8, 40)).astype(np.float32)
    v[:, 10:18] = v[:, :1]
    v[0, 3:7] = [-0.0, 0.0, 0.0, -0.0]
    v[1] = 0.0
    v[2, ::2] = -0.0
    v[3] = -np.abs(v[3])
    v[3, 7:12] = -1.5
    v[4, :3] = [np.inf, -np.inf, np.finfo(np.float32).tiny / 4]
    v[5, ::3] = 2.0
    for k in (1, 7, 18, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                      np.asarray(jv).view(np.int32))


def test_neighbor_topk_matches_jax_with_planted_ties():
    from sparse_coding_tpu.catalog import query as jquery

    a = _arrays(60)
    a["dictionary"][5] = a["dictionary"][2]  # planted ties
    a["dictionary"][9] = a["dictionary"][2]
    x = a["dictionary"][[2, 3, 9]] / np.linalg.norm(
        a["dictionary"][[2, 3, 9]], axis=-1, keepdims=True)
    x[1, :] = 0.0  # all-zero similarities: a full row of ties
    for k in (3, 8):
        got = neighbor_topk(_tied(a, False), torch.from_numpy(x), k)
        ref = np.asarray(jquery.neighbor_topk(_tied(a, True),
                                              jnp.asarray(x), k))
        np.testing.assert_array_equal(got[:, k:].numpy(), ref[:, k:])
        np.testing.assert_allclose(got[:, :k].numpy(), ref[:, :k],
                                   rtol=0, atol=1e-6)
        plain = neighbor_topk_plain(_tied(a, False), torch.from_numpy(x), k)
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    assert list(got[0, 8:11].numpy()) == [2.0, 5.0, 9.0]


def test_serve_flush_plan_counts_like_jax():
    from sparse_coding_tpu.ops.roofline import serve_flush_plan as jplan
    from sparse_coding_tpu_torch.ops.roofline import serve_flush_plan

    for op in ("encode", "decode", "predict", "topk", "neighbors"):
        j, t = jplan(op, 64, N, D, n_stack=3), serve_flush_plan(
            op, 64, N, D, n_stack=3)
        assert (t.hbm_bytes, t.flops) == (j.hbm_bytes, j.mxu_flops)
        assert t.est_s == max(t.hbm_bytes / 3.35e12, t.flops / 67e12)


def test_shared_program_table_under_thread_stress():
    """More threads than cores replay one program table through two
    engines at a short switch interval: every result equals a lone
    engine's, so no replay read another's staged rows (the table's
    replay lock)."""
    import os
    import sys
    import threading

    _, treg = _registries()
    payloads = [_payload(100 + i, "encode", 1 + i % 16) for i in range(48)]
    with ServingEngine(treg, buckets=BUCKETS, ops=("encode",),
                       device="cpu") as lone:
        lone.warmup()
        want = [lone.run_padded("stack", "encode", x)[1] for x in payloads]
    table = tengine.ProgramCache()
    engines = [ServingEngine(treg, buckets=BUCKETS, ops=("encode",),
                             program_cache=table, device="cpu")
               for _ in range(2)]
    engines[0].warmup()
    bad, done = [], []

    def run(k):
        eng = engines[k % 2]
        for i in range(k % 3, len(payloads), 3):
            got = eng.run_padded("stack", "encode", payloads[i])[1]
            if not np.array_equal(got, want[i]):
                bad.append(i)
        done.append(k)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range((os.cpu_count() or 2) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(prev)
        for eng in engines:
            eng.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and bad == []
