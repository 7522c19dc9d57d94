"""The port's autotuner (``repro_torch.tune``) and plan selection
(``core.dispatch.select_plan``) against the reference's ``repro.tune``.

* the port's pruned space equals the reference's Pallas candidates
  restricted to the ported variants and projected onto (variant, block_k,
  combine, depth): the M/N tiles are the only axes the port drops;
* ``cost_prior`` equals the reference's at its default 128 x 128 M/N tiles,
  and so does the prior plan, ranked over the ported variants;
* with the same table (keys renamed pallas -> cuda, loaded from the
  reference's JSON, whose block_m/block_n are ignored) ``select_plan``
  returns the reference's plan projected, table hits and prior-path misses
  alike, when the reference's prior is the same ranking (its own also
  ranks M/N tiles and variants the port has not ported);
* tables round-trip; ``python -m repro_torch.tune --shapes smoke --device
  cpu`` writes a table whose every winner passes ``check_plan``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.core import dispatch as jax_dispatch  # noqa: E402
from repro.tune import space as jax_space  # noqa: E402
from repro.tune.table import TuningTable as JaxTable  # noqa: E402
from repro_torch.core.dispatch import (KERNEL_VARIANTS,  # noqa: E402
                                       ExecPlan, analytic_plan,
                                       numerics_fingerprint, select_plan)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.tune import runner, space  # noqa: E402
from repro_torch.tune.__main__ import main as tune_main  # noqa: E402
from repro_torch.tune.table import (  # noqa: E402
    TuningTable, get_active_table, key_for, use_table)

SHAPES = [(16, 32, 16), (4, 2048, 8192), (64, 300, 130), (8, 8192, 2048),
          (1, 40, 5), (2048, 2048, 8192), (32, 1536, 40)]
WIDTHS = [4, 8, 9, 12, 14, 15, 16, 17, 20, 24, 26]


def _proj(p):
    return (p.variant, p.block_k, p.combine_int32, p.depth)


def _jax_plan(p: ExecPlan, tile: int = 128):
    """The reference plan of a port plan, at M/N tiles ``tile`` (128, the
    reference's default, prices it; 32 is valid at every shape)."""
    return jax_dispatch.ExecPlan(p.variant, p.w, p.m, backend="pallas",
                                 block_m=tile, block_n=tile,
                                 block_k=p.block_k,
                                 combine_int32=p.combine_int32,
                                 depth=p.depth)


def _jax_prior_128(shape, w, m=8, backend="pallas", exact=False):
    """The reference's prior ranking over its candidates of the ported
    variants, each priced at the default 128 x 128 M/N tiles, ties to the
    first in the reference's order (its own prior also ranks M/N tiles
    and the variants the port has not ported)."""
    want = jax_dispatch.numerics_fingerprint(
        jax_dispatch.analytic_plan(w, m, backend=backend, exact=exact))
    best, best_cost = None, None
    for c in jax_space.candidates(shape, w, m=m, backend=backend):
        if c.variant not in KERNEL_VARIANTS \
                or jax_dispatch.numerics_fingerprint(c) != want:
            continue
        cost = jax_space.cost_prior(
            dataclasses.replace(c, block_m=128, block_n=128), shape)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best and dataclasses.replace(best, source="prior")


@pytest.mark.parametrize("w", WIDTHS)
def test_pruned_space_matches_reference(w):
    for shape in SHAPES:
        ref = {_proj(p) for p in jax_space.candidates(shape, w,
                                                      backend="pallas")
               if p.variant in KERNEL_VARIANTS}
        got = space.pruned_space(shape, w)
        assert {_proj(p) for p in got} == ref, (shape, w)
        assert len(got) == len(ref)
        costs = [space.cost_prior(p, shape) for p in got]
        assert costs == sorted(costs)
        for p in got:
            assert space.validate(p, shape) is None
            assert jax_space.validate(_jax_plan(p, 32), shape) is None


@pytest.mark.parametrize("w", WIDTHS)
def test_cost_prior_and_prior_plan_match_reference(w):
    for shape in SHAPES:
        for p in space.candidates(shape, w):
            assert space.cost_prior(p, shape) == jax_space.cost_prior(
                _jax_plan(p), shape), (p, shape)
        ref = _jax_prior_128(shape, w)
        got = space.prior_plan(shape, w)
        assert (got is None) == (ref is None)
        if got is not None:
            assert _proj(got) == _proj(ref) and got.source == "prior"
            assert numerics_fingerprint(got) == numerics_fingerprint(
                analytic_plan(w))


def test_validate_rejects_what_the_port_cannot_run():
    shape = (16, 64, 16)
    assert "unknown backend" in space.validate(
        ExecPlan("strassen", 8, backend="xla", combine_int32=True), shape)
    assert "cuda only" in space.validate(
        ExecPlan("strassen+kmm2", 8, backend="aten", combine_int32=True),
        shape)
    assert space.validate(ExecPlan("fused", 12, backend="pallas"),
                          shape) is not None
    assert "s8" in space.validate(ExecPlan("kmm2", 16), shape)
    assert "headroom" in space.validate(
        ExecPlan("kmm2", 12, combine_int32=True), (16, 4096, 16))
    assert "oversized" in space.validate(ExecPlan("kmm2", 12, block_k=256),
                                         (16, 64, 16))
    assert space.validate(ExecPlan("kmm2", 12, block_k=32),
                          (16, 8, 16)) is None


def _hostile_reference_table():
    """A reference table with staged, fused and invalid winners, some of
    whose block_k would change the fp32 padded K."""
    t = JaxTable(device="test")

    def put(shape, w, variant, bk, ci=False, depth=1, bm=32, bn=64):
        t.put("pallas", shape, w, jax_dispatch.ExecPlan(
            variant, w, backend="pallas", block_m=bm, block_n=bn,
            block_k=bk, combine_int32=ci, depth=depth), us=1.0)

    put((8, 2048, 8192), 8, "mm1", 64, ci=True, depth=0)
    put((8, 2048, 8192), 12, "kmm2", 128)
    put((8, 2048, 128512), 12, "mm2", 256)            # other fp32 class
    put((64, 2048, 2048), 16, "mm2", 64)
    put((64, 2048, 2048), 20, "kmm2", 256, depth=2)
    put((64, 2048, 2048), 24, "fused", 32, depth=2)
    put((8, 300, 130), 12, "kmm2", 32)                # kp 320 != 512
    put((8, 300, 130), 8, "kmm2", 32, ci=True)        # exact class
    put((8, 40, 8), 14, "kmm2", 256)                  # oversized block_k
    put((8, 2048, 512), 16, "kmm2", 256)              # kmm2 past s8: invalid
    put((8, 4096, 512), 12, "fused", 64, ci=True)     # exact, w=12
    return t


def test_select_plan_with_the_same_table_matches_reference(tmp_path,
                                                           monkeypatch):
    jtable = _hostile_reference_table()
    path = tmp_path / "ref.json"
    jtable.save(path)
    doc = json.loads(path.read_text())
    doc["entries"] = {k.replace("pallas/", "cuda/", 1): v
                      for k, v in doc["entries"].items()}
    path.write_text(json.dumps(doc))
    table = TuningTable.load(path)
    assert all("block_m" in rec for rec in table.entries.values())
    monkeypatch.setattr(jax_dispatch, "_prior_plan_cached",
                        _jax_prior_128)
    n_table = n_prior = 0
    for shape in [(8, 2048, 8192), (5, 2048, 128512), (64, 2048, 2048),
                  (60, 2048, 2048), (8, 300, 130), (8, 40, 8),
                  (8, 2048, 512), (8, 4096, 512), (16, 2048, 8192),
                  (512, 2048, 8192), (4, 1536, 40), (1, 64, 64)]:
        for w in (8, 12, 14, 16, 20, 24):
            ref = jax_dispatch.select_plan(shape, w, backend="pallas",
                                           table=jtable)
            got = select_plan(shape, w, table=table)
            assert _proj(got) == _proj(ref), (shape, w, ref, got)
            assert got.source == ref.source, (shape, w)
            n_table += got.source.startswith("table")
            n_prior += got.source.startswith("prior")
    assert n_table >= 5 and n_prior >= 20
    # A strassen winner in the MM1 window's exact class is served as the
    # reference serves it: the same integer, so the pin lets it in.
    table.entries[key_for("cuda", (8, 2048, 512), 8)] = {
        "variant": "strassen", "block_k": 256, "combine_int32": True,
        "depth": 1}
    jtable.put("pallas", (8, 2048, 512), 8, jax_dispatch.ExecPlan(
        "strassen", 8, backend="pallas", block_k=256, combine_int32=True,
        depth=1), us=1.0)
    got = select_plan((8, 2048, 512), 8, table=table)
    ref = jax_dispatch.select_plan((8, 2048, 512), 8, backend="pallas",
                                   table=jtable)
    assert got.variant == "strassen" and _proj(got) == _proj(ref)


def test_table_roundtrip_and_registry(tmp_path):
    t = TuningTable(device="cpu/plain")
    plan = ExecPlan("kmm2", 12, block_k=64)
    key = t.put("cuda", (5, 300, 130), 12, plan, us=3.5, us_default=None)
    assert key == "cuda/m8/k512/n256/w12/mult8" == key_for(
        "cuda", (7, 260, 200), 12)
    t.save(tmp_path / "t.json")
    loaded = TuningTable.load(tmp_path / "t.json")
    assert loaded.entries == t.entries and loaded.device == "cpu/plain"
    got = loaded.lookup("cuda", (8, 512, 256), 12)
    assert _proj(got) == _proj(plan) and got.source == "table"
    assert loaded.lookup("cuda", (8, 512, 256), 13) is None
    loaded.entries[key_for("cuda", (8, 8, 8), 8)] = {"variant": "mm1"}
    assert loaded.lookup("cuda", (8, 8, 8), 8) is None     # malformed
    doc = json.loads((tmp_path / "t.json").read_text())
    doc["version"] = 2
    (tmp_path / "bad.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="version"):
        TuningTable.load(tmp_path / "bad.json")
    assert get_active_table() is None
    with use_table(tmp_path / "t.json") as active:
        assert get_active_table() is active and len(active) == 1
        assert _proj(select_plan((8, 512, 256), 12)) == _proj(plan)
    assert get_active_table() is None
    assert select_plan((8, 512, 256), 12) == analytic_plan(12)


def test_tune_cli_smoke_writes_gated_winners(tmp_path, capsys):
    out = tmp_path / "smoke.json"
    assert tune_main(["--shapes", "smoke", "--w", "8", "12", "--device",
                      "cpu", "--iters", "1", "--out", str(out)]) == 0
    table = TuningTable.load(out)
    # w=12 at K=64: no plan of the analytic class pads K as the analytic
    # plan does (its block_k of 256 is oversized there), so select_plan
    # would serve no entry and the key is skipped
    assert table.device == "cpu/plain" and len(table) == 3
    assert "cuda/m64/k64/n64/w12/mult8" not in table.entries
    for key, rec in table.entries.items():
        _, m, k, n, w, _ = key.split("/")
        shape = (int(m[1:]), int(k[1:]), int(n[1:]))
        w = int(w[1:])
        plan = table.lookup("cuda", shape, w)
        assert space.validate(plan, shape) is None
        a, b = runner.make_operands(shape, w, seed=0)
        assert runner.check_plan(plan, a, b) == (True, ""), key
        assert rec["n_candidates"] == len(runner.served_candidates(shape, w))
        assert rec["us"] > 0 and rec["n_rejected"] == 0
        assert runner.served_as_is(plan, shape)
    assert "wrote" in capsys.readouterr().out


def test_check_plan_rejects_wrong_candidates(monkeypatch):
    a, b = runner.make_operands((8, 64, 8), 12, seed=1)
    good = ExecPlan("kmm2", 12, block_k=32)
    assert runner.check_plan(good, a, b) == (True, "")
    real = ops.run_plan

    def off_by_one(x, y, *, plan, use_ref_kernels=False):
        out = real(x, y, plan=plan, use_ref_kernels=use_ref_kernels)
        return out if use_ref_kernels else out + 1

    monkeypatch.setattr(ops, "run_plan", off_by_one)
    ok, err = runner.check_plan(good, a, b)
    assert not ok and "mirror" in err
    a8, b8 = runner.make_operands((8, 64, 8), 8, seed=1)
    ok, err = runner.check_plan(
        ExecPlan("mm1", 8, block_k=32, combine_int32=True, depth=0), a8, b8)
    assert not ok and "oracle" in err


@pytest.mark.parametrize("w,dtype", [(4, torch.int8), (8, torch.int8),
                                     (12, torch.int16), (16, torch.int16),
                                     (20, torch.int32), (26, torch.int32)])
def test_operands_come_in_the_serving_carrier(w, dtype):
    """The tuner times the codes the quantized matmul passes: int8 through
    w = m, int16 through 16, int32 above, with values in the w-bit range."""
    a, b = runner.make_operands((8, 64, 16), w, seed=2)
    assert a.dtype == b.dtype == dtype
    lim = 2 ** (w - 1)
    for t in (a, b):
        assert int(t.min()) >= -lim and int(t.max()) < lim


def test_check_plan_propagates_launch_failures(monkeypatch):
    """A RuntimeError (a failed CUDA launch) is a kernel fault, never a
    rejected candidate; the seam's refusals are rejections."""
    a, b = runner.make_operands((8, 64, 8), 12, seed=1)
    plan = ExecPlan("kmm2", 12, block_k=32)

    def boom(*args, **kwargs):
        raise RuntimeError("staged_gemm kmm2 launch failed: CUDA error 700")

    monkeypatch.setattr(ops, "run_plan", boom)
    with pytest.raises(RuntimeError, match="launch failed"):
        runner.check_plan(plan, a, b)

    def refuse(*args, **kwargs):
        raise NotImplementedError("variant not ported")

    monkeypatch.setattr(ops, "run_plan", refuse)
    ok, err = runner.check_plan(plan, a, b)
    assert not ok and err.startswith("execution failed: NotImplementedError")


def test_bench_plan_times_the_serving_call(monkeypatch):
    """bench_plan times the plan with its dequant, as serving runs it."""
    from repro_torch.quant import qmatmul
    calls = []
    real = qmatmul.run_plan_dequant

    def spy(qx, qw, sx, sw, plan, out_dtype, *rest):
        calls.append((qx.dtype, tuple(sx.shape), tuple(sw.shape), out_dtype))
        return real(qx, qw, sx, sw, plan, out_dtype, *rest)

    monkeypatch.setattr(qmatmul, "run_plan_dequant", spy)
    a, b = runner.make_operands((8, 64, 16), 8, seed=1)
    us = runner.bench_plan(ExecPlan("mm1", 8, block_k=32,
                                    combine_int32=True, depth=0), a, b,
                           iters=2)
    assert us > 0
    assert calls == [(torch.int8, (8, 1), (1, 16), torch.bfloat16)] * 3


def test_tune_shape_reports_default_and_winner():
    """The sweep times the analytic default first and the staged kmm2 of
    its class (w=12's fp32 kmm2 class, same padded K); mm2 is another
    class, which select_plan would not serve, so it is not timed."""
    shape = (8, 512, 16)
    res = runner.tune_shape(shape, 12, iters=1, device="cpu")
    assert res.winner is not None and all(m.ok for m in res.measurements)
    assert [m.plan.variant for m in res.measurements] == ["fused", "kmm2"]
    assert res.measurements[0].plan == analytic_plan(12)
    # the sweep's time, or where the winner beat it by more than the
    # margin, the median of their re-times in turns
    assert res.default_us == res.measurements[0].us or res.retimed
    assert res.default_us > 0 and res.speedup_vs_default > 0
    assert runner.served_as_is(res.winner, shape)
    assert runner.device_label("cpu") == "cpu/plain"


def test_outlying_default_time_does_not_pick_a_slower_winner(monkeypatch):
    """The sweep's one time of the default is an outlier (10x its true
    time), so the staged kmm2 beats it by more than RETIME_MARGIN; re-timed
    in turns with the default, kmm2 is the slower one, and the recorded
    winner is the default with the re-timed medians."""
    shape = (8, 512, 16)
    true_us = {"fused": 10.0, "kmm2": 12.0}
    seen, outlier = [], [True]

    def bench(plan, a, b, iters=3, detail=None):
        seen.append(plan.variant)
        if plan.variant == "fused" and outlier[0]:
            outlier[0] = False
            return 10 * true_us["fused"]
        return true_us[plan.variant]

    monkeypatch.setattr(runner, "bench_plan", bench)
    res = runner.tune_shape(shape, 12, iters=1, device="cpu")
    assert res.retimed
    assert res.winner == analytic_plan(12)
    assert (res.winner_us, res.default_us) == (10.0, 10.0)
    assert res.measurements[0].us == 100.0      # the sweep's outlier, kept
    assert seen == ["fused", "kmm2"] + ["fused", "kmm2"] * \
        runner.RETIME_ROUNDS
    # a true winner survives its re-time, with its re-timed numbers
    true_us["kmm2"] = 5.0
    seen.clear()
    res = runner.tune_shape(shape, 12, iters=1, device="cpu")
    assert res.retimed and res.winner.variant == "kmm2"
    assert (res.winner_us, res.default_us) == (5.0, 10.0)
    # within the margin no re-time
    true_us["kmm2"] = 9.9
    seen.clear()
    res = runner.tune_shape(shape, 12, iters=1, device="cpu")
    assert not res.retimed and seen == ["fused", "kmm2"]


@pytest.mark.parametrize("w", [8, 12, 16, 20])
def test_served_candidates_one_per_distinct_launch(w):
    """Candidates that launch the same kernel on the same padded K count
    once (block_k only fixes the padded K on CUDA), fused mm1 once (it
    never reads the padded K), and every one is served as it is: in the
    analytic plan's numerics class with, for fp32 plans, its padded K."""
    for shape in SHAPES:
        got = runner.served_candidates(shape, w)
        if shape[1] >= 128:
            assert got[0] == analytic_plan(w)
        keys = [runner.launch_key(p, shape[1]) for p in got]
        assert len(keys) == len(set(keys))
        base = numerics_fingerprint(analytic_plan(w))
        pad = lambda p: -(-shape[1] // p.block_k) * p.block_k  # noqa: E731
        for p in got:
            assert space.validate(p, shape) is None
            assert numerics_fingerprint(p) == base
            if not p.is_exact_int:
                assert pad(p) == pad(analytic_plan(w))
            assert runner.served_as_is(p, shape)
        # every served plan of the space launches like one kept
        for p in space.pruned_space(shape, w):
            if runner.served_as_is(p, shape):
                assert runner.launch_key(p, shape[1]) in keys
        if w <= 8:
            assert sum(p.variant == "fused" for p in got) == 1


def test_record_is_what_select_plan_serves(tmp_path):
    """A swept table's winners come back from select_plan unchanged, and
    a plan outside the served class is not served as it is."""
    shape = (8, 512, 16)
    out = tmp_path / "t.json"
    assert tune_main(["--shapes", "8x512x16", "--w", "12", "16", "--device",
                      "cpu", "--iters", "1", "--out", str(out)]) == 0
    table = TuningTable.load(out)
    for w in (12, 16):
        plan = table.lookup("cuda", shape, w)
        assert _proj(select_plan(shape, w, table=table)) == _proj(plan)
    other = ExecPlan("fused_mm2", 12, block_k=256)    # the mm2 class
    assert space.validate(other, shape) is None
    assert not runner.served_as_is(other, shape)
    short = ExecPlan("kmm2", 12, block_k=32)           # the analytic class,
    assert not runner.served_as_is(short, (8, 300, 16))  # another padded K


class _FakeCuda:
    """A device timeline for ``runner.device_time_us``: a call takes
    ``host_ms`` of host time to enqueue and ``dev_ms`` on the device, which
    runs work in order once it is enqueued; ``_sleep`` queues a sleep of
    cycles / 2e6 ms; an event completes when the device reaches it."""

    def __init__(self, host_ms, dev_ms, pause_at=None, pause_ms=0.0):
        self.now, self.free = 0.0, 0.0
        self.host_ms, self.dev_ms = host_ms, dev_ms
        self.sleeps = []
        self.calls, self.pause_at, self.pause_ms = 0, pause_at, pause_ms
        fake = self

        class Event:
            def __init__(self, enable_timing=True):
                self.at = None

            def record(self):
                self.at = max(fake.free, fake.now)

            def synchronize(self):
                fake.now = max(fake.now, self.at)

            def elapsed_time(self, other):
                return other.at - self.at

        self.Event = Event

    def clock(self):
        return self.now / 1e3

    def synchronize(self):
        self.now = max(self.now, self.free)

    def _sleep(self, cycles):
        self.sleeps.append(cycles / runner.SLEEP_CYCLES_PER_MS)
        self.free = max(self.free, self.now) + cycles / 2e6

    def call(self):
        self.free = max(self.free, self.now) + self.dev_ms
        self.now += self.host_ms
        self.calls += 1
        if self.calls == self.pause_at:      # a pause of the host
            self.now += self.pause_ms


@pytest.mark.parametrize("host_ms,dev_ms,pause_at", [
    (0.05, 0.01, None), (0.05, 0.2, None), (0.3, 0.004, None),
    (0.002, 0.5, None), (0.05, 0.01, 5), (0.3, 0.004, 5)])
def test_bench_lead_covers_the_host_on_a_stubbed_clock(host_ms, dev_ms,
                                                       pause_at):
    """The lead outlasts enqueuing every timed call, so the events time the
    device (even where the host takes 75x longer than the kernel), over
    enough calls to cover MIN_DEVICE_MS; a host pause during the timed
    calls (the 5th call: the first timed one) is seen and the measurement
    taken again behind a longer lead.  Without a lead the same events
    would time the host."""
    fake = _FakeCuda(host_ms, dev_ms, pause_at, pause_ms=5.0)
    us, info = runner.device_time_us(fake.call, 3, cuda=fake,
                                     clock=fake.clock)
    assert us == pytest.approx(dev_ms * 1e3)
    assert info["lead_ms"] == pytest.approx(fake.sleeps[-1])
    assert info["lead_ms"] > info["iters"] * host_ms
    assert len(fake.sleeps) >= (2 if pause_at else 1)
    assert info["iters"] * dev_ms >= runner.MIN_DEVICE_MS - 1e-12
    assert info["iters"] >= 3 and info["host_us"] == pytest.approx(
        host_ms * 1e3)
