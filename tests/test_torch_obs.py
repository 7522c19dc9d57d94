"""The port's observability (repro_torch.obs) against the reference's
(repro.obs), on the CPU:

  * the registry and tracer semantics of tests/test_obs.py, run on the
    port's ``metrics`` / ``trace``;
  * one sequence of instrument calls on both registries gives the same
    snapshot and Prometheus text;
  * serving with metrics and tracing on: greedy tokens equal with obs off
    and to the JAX engine (llama smoke, mixed, float32, 2 slots, chunked
    prefill with prefix sharing), and the host-loop counters equal the JAX
    engine's snapshot on the same requests — admissions, finishes by
    reason, TTFT and decode-step counts, lane widths, prefix-cache events,
    the last queue depth and occupancy;
  * one MoE prefill (granite smoke): ``repro_moe_tokens_per_expert`` and
    ``repro_moe_dropped_tokens_total``, accumulated on the device and
    folded at the snapshot, equal the reference's ``jax.debug.callback``
    observations;
  * the stop-token path: a stop token taken from a stream position whose
    token did not occur earlier in that stream ends that stream there, 1
    slot and 3 slots agree, and streams and stop reasons equal the JAX
    engine's;
  * ``launch/serve.py --device cpu --metrics-out --trace-out``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.obs import metrics as jax_metrics  # noqa: E402
from repro.obs import trace as jax_trace  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 48
# The reference's _tiny_cfg, untied: with the tied embedding a random-init
# model's greedy stream repeats its last prompt token, and a stop token
# could only end a stream at its first token.
TINY = dict(d_model=64, d_ff=128, vocab_size=256, n_heads=4, n_kv_heads=2,
            head_dim=16, compute_dtype="float32", tie_embeddings=False)


def _off_and_clean(*mods):
    for m in mods:
        m.disable()
    for m in mods:
        (m.reset if hasattr(m, "reset") else m.clear)()


@pytest.fixture()
def obs_on():
    """Port metrics+trace enabled with clean state; disabled and clean
    after."""
    metrics.reset()
    trace.clear()
    metrics.enable()
    trace.enable()
    try:
        yield
    finally:
        _off_and_clean(metrics, trace)


def _cfgs(arch, backends=("pallas", "cuda"), **kw):
    jcfg = jax_get_config(arch, smoke=True, quant="mixed")
    jcfg = jcfg.with_quant(dataclasses.replace(jcfg.quant,
                                               backend=backends[0]))
    tcfg = get_config(arch, smoke=True, quant="mixed")
    tcfg = tcfg.with_quant(dataclasses.replace(tcfg.quant,
                                               backend=backends[1]))
    return jcfg.scaled_down(**kw), tcfg.scaled_down(**kw)


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = _cfgs("llama3.2-1b", **TINY)
    jparams = jax_lm.init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, jparams, tcfg, params_from_jax(
        jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def llama_digit_route(llama):
    """The same weights with every GEMM on the digit recursion: the
    reference's "xla" route and the port's "aten" (fastest to compile)."""
    jcfg, tcfg = _cfgs("llama3.2-1b", ("xla", "aten"), **TINY)
    return jcfg, llama[1], tcfg, llama[3]


# ---------------------------------------------------------------------------
# Registry and tracer semantics (tests/test_obs.py, on the port)
# ---------------------------------------------------------------------------


def test_disabled_records_nothing():
    metrics.reset()
    assert not metrics.enabled()
    c = metrics.counter("t_disabled_total", labels=("k",))
    g = metrics.gauge("t_disabled_gauge")
    h = metrics.histogram("t_disabled_seconds")
    c.inc("a")
    g.set(5.0)
    h.observe(0.2)
    assert c.value("a") == 0.0 and c.total() == 0.0
    assert g.value() == 0.0
    assert h.count() == 0 and h.sum() == 0.0


def test_counter_semantics(obs_on):
    c = metrics.counter("t_counter_total", "help", labels=("route",))
    c.inc("fast")
    c.inc("fast", by=2)
    c.inc("slow", by=0.5)
    assert c.value("fast") == 3.0
    assert c.value("slow") == 0.5
    assert c.total() == 3.5
    with pytest.raises(ValueError):
        c.inc("fast", by=-1)
    with pytest.raises(ValueError):
        c.inc()                      # label arity mismatch


def test_gauge_set_add(obs_on):
    g = metrics.gauge("t_gauge")
    g.set(4.0)
    g.set(2.0)
    g.add(0.5)
    assert g.value() == 2.5


def test_histogram_buckets_cumulative(obs_on):
    h = metrics.histogram("t_lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count() == 5
    assert h.sum() == pytest.approx(5.605)
    snap = h._snapshot_values()[""]
    assert snap["buckets"] == {"0.01": 1, "0.1": 3, "1.0": 4, "+Inf": 5}


def test_registration_idempotent_and_conflicting():
    c1 = metrics.counter("t_reg_total", labels=("a",))
    c2 = metrics.counter("t_reg_total", labels=("a",))
    assert c1 is c2
    with pytest.raises(ValueError):
        metrics.counter("t_reg_total", labels=("b",))     # label mismatch
    with pytest.raises(ValueError):
        metrics.gauge("t_reg_total", labels=("a",))       # kind mismatch


def test_snapshot_deterministic_and_reset(obs_on):
    c = metrics.counter("t_snap_total", labels=("x",))
    c.inc("b")
    c.inc("a")
    s1 = json.dumps(metrics.snapshot(), sort_keys=True)
    s2 = json.dumps(metrics.snapshot(), sort_keys=True)
    assert s1 == s2
    doc = metrics.snapshot()["t_snap_total"]
    assert doc["type"] == "counter"
    assert list(doc["values"]) == ["x=a", "x=b"]          # sorted label sets
    metrics.reset()
    assert metrics.snapshot()["t_snap_total"]["values"] == {}
    assert metrics.get("t_snap_total") is c               # registration kept


def test_prometheus_text(obs_on):
    c = metrics.counter("t_prom_total", "prom help", labels=("r",))
    c.inc("x", by=2)
    h = metrics.histogram("t_prom_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    txt = metrics.prometheus_text()
    assert "# HELP t_prom_total prom help" in txt
    assert "# TYPE t_prom_total counter" in txt
    assert 't_prom_total{r="x"} 2.0' in txt
    assert 't_prom_seconds_bucket{le="0.1"} 1' in txt
    assert 't_prom_seconds_bucket{le="+Inf"} 2' in txt
    assert "t_prom_seconds_count 2" in txt


def test_counter_thread_safety(obs_on):
    c = metrics.counter("t_threads_total", labels=("t",))
    n_threads, n_incs = 8, 500

    def worker(i):
        for _ in range(n_incs):
            c.inc(i % 2)

    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.total() == n_threads * n_incs


def test_disabled_span_is_shared_null():
    assert not trace.enabled()
    s1 = trace.span("a", k=1)
    s2 = trace.span("b")
    assert s1 is s2                   # singleton: no per-call allocation
    with s1 as sp:
        sp.set(x=2)                   # no-op, no error
    trace.instant("nothing")
    assert trace.events() == []


def test_span_nesting_and_chrome_schema(obs_on):
    with trace.span("outer", step=1):
        with trace.span("inner", w=4) as sp:
            sp.set(late=True)
    trace.instant("marker", y=2)
    trace.begin_async("request", 7, prompt_len=3)
    trace.end_async("request", 7, reason="length")

    doc = trace.chrome_trace()
    assert doc["displayTimeUnit"] == "ms"
    ev = {e["name"]: e for e in doc["traceEvents"]}
    assert set(ev) == {"outer", "inner", "marker", "request"}
    inner, outer = ev["inner"], ev["outer"]
    for e in (inner, outer):
        assert e["ph"] == "X" and e["cat"] == "repro"
        assert isinstance(e["ts"], float) and e["dur"] >= 0
        assert "pid" in e and "tid" in e
    assert outer["args"]["depth"] == 0
    assert inner["args"]["depth"] == 1
    assert inner["args"]["parent"] == "outer"
    assert inner["args"]["late"] is True
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert ev["marker"]["ph"] == "i"
    reqs = [e for e in doc["traceEvents"] if e["name"] == "request"]
    assert sorted(e["ph"] for e in reqs) == ["b", "e"]
    assert all(e["id"] == "7" for e in reqs)
    json.dumps(doc)


def test_export_chrome(obs_on, tmp_path):
    with trace.span("one"):
        pass
    out = tmp_path / "trace.json"
    trace.export_chrome(str(out))
    doc = json.loads(out.read_text())
    assert [e["name"] for e in doc["traceEvents"]] == ["one"]


# ---------------------------------------------------------------------------
# The same calls on both registries: the same snapshot and Prometheus text
# ---------------------------------------------------------------------------


def _drive(m, t):
    c = m.counter("t_par_total", "par help", labels=("route",))
    g = m.gauge("t_par_gauge", "gauge help")
    h = m.histogram("t_par_seconds", "hist help", labels=("k",),
                    buckets=(0.01, 0.1, 1.0))
    hd = m.histogram("t_par_default_seconds")
    for i, v in enumerate((0.005, 0.05, 0.5, 5.0, 0.1, 0.01, 0.0)):
        h.observe(v, "a" if i % 2 else "b")
        hd.observe(v)
        c.inc("x" if i % 3 else 'y"q\\z', by=i)
    g.set(3.5)
    g.add(-1.25)
    with t.span("outer", step=1):
        with t.span("inner", w=4) as sp:
            sp.set(lanes=2)
    t.instant("marker", y=2)
    t.begin_async("request", 3, prompt_len=5)
    t.end_async("request", 3, reason="length")


def _par(snapshot, text):
    snap = {k: v for k, v in snapshot.items() if k.startswith("t_par")}
    lines = [ln for ln in text.splitlines()
             if ln.split(" ")[0].startswith("t_par")
             or ln.startswith(("# HELP t_par", "# TYPE t_par"))]
    return snap, lines


def _schema(events):
    """Events without their clocks and ids of the process / thread."""
    drop = ("ts", "dur", "pid", "tid")
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


def test_registries_agree_on_the_same_calls():
    mods = (metrics, trace, jax_metrics, jax_trace)
    for m in mods:
        (m.reset if hasattr(m, "reset") else m.clear)()
        m.enable()
    try:
        _drive(metrics, trace)
        _drive(jax_metrics, jax_trace)
        got = _par(metrics.snapshot(), metrics.prometheus_text())
        want = _par(jax_metrics.snapshot(), jax_metrics.prometheus_text())
        assert got == want
        assert len(got[0]) == 4 and len(got[1]) > 20
        assert _schema(trace.events()) == _schema(jax_trace.events())
        assert trace.chrome_trace().keys() == jax_trace.chrome_trace().keys()
    finally:
        _off_and_clean(*mods)


# ---------------------------------------------------------------------------
# Serving with observability on
# ---------------------------------------------------------------------------

# prompts sharing a 20-token head, so that chunked prefill with prefix
# sharing stores, hits and misses
TAILS = (4, 7, 2, 9)
HOST_LOOP = ("repro_serve_admitted_total", "repro_serve_finished_total",
             "repro_serve_decode_lane_width_total",
             "repro_serve_prefix_cache_total", "repro_serve_queue_depth",
             "repro_serve_occupancy")


def _prompts():
    rng = np.random.default_rng(1)
    head = [int(t) for t in rng.integers(1, 250, size=20)]
    return [head + [int(t) for t in rng.integers(1, 250, size=n)]
            for n in TAILS]


def _serve(engine_cls, request_cls, cfg, params, **kw):
    eng = engine_cls(cfg, params, max_seq=MAX_SEQ, batch_size=2,
                     prefill_chunk=8, prefix_cache=True, **kw)
    reqs = [request_cls(prompt=list(p), max_new_tokens=5)
            for p in _prompts()]
    eng.generate(reqs)
    return [r.generated for r in reqs], eng


def _host_loop(snap):
    out = {k: snap[k]["values"] for k in HOST_LOOP}
    for k in ("repro_serve_ttft_seconds", "repro_serve_decode_step_seconds"):
        out[k] = {lab: v["count"] for lab, v in snap[k]["values"].items()}
    return out


def test_serve_obs_on_matches_off_and_jax_engine(llama):
    jcfg, jparams, tcfg, tparams = llama
    off, _ = _serve(Engine, Request, tcfg, tparams, device="cpu")
    jax_metrics.reset()
    jax_metrics.enable()
    try:
        want, jeng = _serve(JaxEngine, JaxRequest, jcfg, jparams)
        want_snap = jax_metrics.snapshot()
    finally:
        _off_and_clean(jax_metrics)
    metrics.reset()
    trace.clear()
    metrics.enable()
    trace.enable()
    try:
        got, eng = _serve(Engine, Request, tcfg, tparams, device="cpu")
        snap = metrics.snapshot()
        events = trace.events()
    finally:
        _off_and_clean(metrics, trace)
    assert got == off == want
    assert all(len(g) == 5 for g in got)
    assert eng.prefix.stats() == jeng.prefix.stats()
    assert eng.prefix.stats()["hits"] >= 1
    assert _host_loop(snap) == _host_loop(want_snap)
    assert snap["repro_serve_admitted_total"]["values"][""] == len(TAILS)
    assert snap["repro_serve_ttft_seconds"]["values"][""]["count"] \
        == len(TAILS)
    assert set(snap["repro_serve_prefix_cache_total"]["values"]) >= {
        "event=hit", "event=miss", "event=store"}
    retr = snap["repro_serve_retraces_total"]["values"]
    assert retr == {f"kind={k}": float(n)
                    for k, n in eng.n_traces().items()}
    # every GEMM on the kernels' route, counted by the registry as by
    # gemm_routes(); the reference's metric names all registered
    routes = snap["repro_quant_gemm_routes_total"]["values"]
    assert list(routes) == ["backend=cuda,route=cuda"] and routes[
        "backend=cuda,route=cuda"] > 0
    assert set(want_snap) - set(snap) <= {"repro_shard_gemm_fallback_total"}
    names = {e["name"] for e in events}
    assert {"engine_step", "decode_step", "prefill_chunk", "request",
            "run_plan"} <= names
    reqs = [e for e in events if e["name"] == "request"]
    assert sorted(e["ph"] for e in reqs) == ["b"] * 4 + ["e"] * 4
    # nothing sticks: off again, the same tokens and nothing recorded
    again, _ = _serve(Engine, Request, tcfg, tparams, device="cpu")
    assert again == off
    assert trace.events() == [] and metrics.snapshot()[
        "repro_serve_admitted_total"]["values"] == {}


def test_moe_dispatch_metrics_match_reference():
    """One granite smoke prefill (2 sequences of 32 tokens, so capacity
    drops; the reference's prefill jitted, whose callback runs on every
    call): the port's device accumulators, folded at the snapshot, equal
    the reference's per-call callback observations, layer for layer."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", compute_dtype="float32")
    jparams = jax_lm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    names = ("repro_moe_tokens_per_expert", "repro_moe_dropped_tokens_total")
    jax_metrics.reset()
    jax_metrics.enable()
    try:
        jax.block_until_ready(jax.jit(jax_lm.prefill, static_argnums=1)(
            jparams, jcfg, jax.numpy.asarray(toks),
            jax_lm.init_cache(jcfg, 2, 32)))
        want = {k: jax_metrics.snapshot()[k]["values"] for k in names}
    finally:
        _off_and_clean(jax_metrics)
    metrics.reset()
    metrics.enable()
    try:
        with torch.inference_mode():
            lm.prefill(tparams, tcfg, torch.as_tensor(toks),
                       lm.init_cache(tcfg, 2, 32, device="cpu"))
        got = {k: metrics.snapshot()[k]["values"] for k in names}
        # the accumulators were folded once and zeroed: no double count
        assert {k: metrics.snapshot()[k]["values"] for k in names} == got
    finally:
        _off_and_clean(metrics)
    assert got == want
    obs = got["repro_moe_tokens_per_expert"]
    assert obs and all(v["count"] == 2 * tcfg.n_experts * tcfg.n_periods
                       for v in obs.values())
    assert sum(got["repro_moe_dropped_tokens_total"].values()) > 0
    # disabled: the step records nothing
    with torch.inference_mode():
        lm.prefill(tparams, tcfg, torch.as_tensor(toks),
                   lm.init_cache(tcfg, 2, 32, device="cpu"))
    assert metrics.snapshot()["repro_moe_tokens_per_expert"]["values"] == {}


# ---------------------------------------------------------------------------
# The stop-token path
# ---------------------------------------------------------------------------

# (prompt length, max_new_tokens), greedy
STOP_SPEC = ((3, 6), (9, 1), (5, 8), (12, 4), (2, 5))


def _stop_run(engine_cls, request_cls, cfg, params, slots, stop, **kw):
    rng = np.random.default_rng(0)
    reqs = [request_cls(prompt=[int(t) for t in rng.integers(
                1, cfg.vocab_size, size=n)],
                max_new_tokens=m, stop_tokens=stop)
            for n, m in STOP_SPEC]
    eng = engine_cls(cfg, params, max_seq=MAX_SEQ, batch_size=slots,
                     rng_seed=3, **kw)
    eng.generate(reqs)
    return ([r.generated for r in reqs],
            [r.stats.stop_reason for r in reqs])


def test_stop_token_matches_jax_engine(llama_digit_route):
    jcfg, jparams, tcfg, tparams = llama_digit_route
    plain, reasons = _stop_run(Engine, Request, tcfg, tparams, 3, (),
                               device="cpu")
    assert [len(g) for g in plain] == [m for _, m in STOP_SPEC]
    assert set(reasons) == {"length"}
    # the stop token: the longest stream's first token from position 2 on
    # that did not occur earlier in that stream
    long = plain[2]
    at = next(i for i in range(2, len(long)) if long[i] not in long[:i])
    eos = long[at]
    got3, why3 = _stop_run(Engine, Request, tcfg, tparams, 3, (eos,),
                           device="cpu")
    got1, why1 = _stop_run(Engine, Request, tcfg, tparams, 1, (eos,),
                           device="cpu")
    want, why = _stop_run(JaxEngine, JaxRequest, jcfg, jparams, 1, (eos,))
    assert got3 == got1 == want
    assert why3 == why1 == why
    assert got3[2] == long[:at + 1] and why3[2] == "stop_token"
    for g, r, (_, m) in zip(got3, why3, STOP_SPEC):
        assert len(g) <= m
        assert (r == "stop_token") == (eos in g)
        assert eos not in g[:-1]


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launcher_writes_metrics_and_trace(tmp_path):
    m_out, t_out = tmp_path / "m.json", tmp_path / "t.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--quant", "mixed", "--requests", "3", "--max-new", "3",
         "--max-seq", "64", "--metrics-out", str(m_out), "--trace-out",
         str(t_out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr
    snap = json.loads(m_out.read_text())
    assert snap["repro_serve_admitted_total"]["values"][""] == 3
    assert sum(snap["repro_serve_finished_total"]["values"].values()) == 3
    assert snap["repro_serve_ttft_seconds"]["values"][""]["count"] == 3
    assert snap["repro_serve_retraces_total"]["values"]["kind=decode"] >= 1
    names = {e["name"] for e in json.loads(t_out.read_text())["traceEvents"]}
    assert {"engine_step", "decode_step", "prefill_chunk", "request",
            "run_plan"} <= names
