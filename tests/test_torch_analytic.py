"""The port's analytic models against the reference's, exactly (==), over
the sweeps of tests/test_complexity.py and tests/test_obs.py:

  * ``obs.traffic``: ``analytic_bytes`` for every kind over shapes, widths
    and tiles; the analytic rows and pair rows against the reference's
    ``traffic_rows`` (its measurement stubbed: only the analytic fields are
    compared) and ``traffic_checks`` on the same rows; the measured side
    raising ``NotImplementedError``;
  * ``core.complexity`` (Eqs. 2-8), ``core.area`` (Eqs. 16-23) and
    ``core.efficiency`` (Eqs. 11-15, Fig. 11), and ``core.dispatch``'s
    ``conv_mults_per_product`` / ``conv_recursion`` / ``efficiency_roof``
    / ``schedule``; plus the paper's claims of tests/test_complexity.py on
    the port.
"""
import math

import pytest

pytest.importorskip("torch")

from repro.core import area as ref_area  # noqa: E402
from repro.core import complexity as ref_cx  # noqa: E402
from repro.core import dispatch as ref_dispatch  # noqa: E402
from repro.core import efficiency as ref_eff  # noqa: E402
from repro.obs import traffic as ref_traffic  # noqa: E402
from repro_torch.core import area, complexity as cx  # noqa: E402
from repro_torch.core import dispatch, efficiency  # noqa: E402
from repro_torch.obs import traffic  # noqa: E402

KINDS = ("xla", "fused", "fused_mm2", "fused_d2", "staged", "staged_mm2",
         "staged_d2", "grouped", "strassen_kmm2", "strassen_xla")
SHAPES = ((64, 256, 64), (128, 4096, 128), (5, 300, 130), (256, 4096, 256),
          (1, 2048, 8192), (2048, 8192, 2048), (7, 1, 3))
WIDTHS = (4, 8, 9, 12, 15, 16, 17, 20, 24, 26)
TILES = ((64, 64, 64), (128, 128, 256), (16, 128, 512), (32, 64, 1024))


# ---------------------------------------------------------------------------
# Traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_bytes_equal_reference(kind):
    n = 0
    for shape in SHAPES:
        for w in WIDTHS:
            for m in (8, 4):
                for tiles in TILES:
                    for e in (1, 4):
                        got = traffic.analytic_bytes(kind, shape, w=w, m=m,
                                                     tiles=tiles,
                                                     n_experts=e)
                        assert got == ref_traffic.analytic_bytes(
                            kind, shape, w=w, m=m, tiles=tiles,
                            n_experts=e), (kind, shape, w, m, tiles, e)
                        assert got > 0
                        n += 1
    assert n == len(SHAPES) * len(WIDTHS) * 2 * len(TILES) * 2
    with pytest.raises(ValueError):
        traffic.analytic_bytes("nope", SHAPES[0], tiles=TILES[0])


def test_traffic_constants_equal_reference():
    for name in ("DEFAULT_SHAPES", "SMOKE_SHAPES", "DEFAULT_W",
                 "RATIO_WINDOW", "CONSISTENCY_MAX", "TRAFFIC_KINDS",
                 "EXTENDED_KINDS", "FUSED_PAIRS", "STRASSEN_W",
                 "STRASSEN_SHAPES", "STRASSEN_KINDS", "ANALYTIC_PAIRS",
                 "GROUPED_W", "GROUPED_EXPERTS"):
        assert getattr(traffic, name) == getattr(ref_traffic, name), name
    for w in range(1, 33):
        for m in (4, 8):
            assert traffic._carrier_bytes(w, m) == \
                ref_traffic._carrier_bytes(w, m)


def _ref_rows(monkeypatch, shapes, **kw):
    """The reference's traffic rows with its measurement stubbed (fixed
    bytes by plan variant), so that only the analytic fields and the check
    logic are compared."""
    from repro.kernels import ops as ref_ops

    class _Lowered:
        def __init__(self, plan):
            self.plan = plan

    class _Jit:
        @staticmethod
        def lower(a, b, plan, interpret):
            return _Lowered(plan)

    monkeypatch.setattr(ref_ops, "run_plan_jit", _Jit)
    monkeypatch.setattr(ref_traffic, "measure_costs", lambda lowered: {
        "flops": 1.0, "bytes": 1.0e6 * (1 + len(lowered.plan.variant)),
        "method": "stub"})
    return ref_traffic.traffic_rows(shapes, **kw)


ANALYTIC_KEYS = ("name", "kind", "shape", "w", "tiles", "analytic_bytes",
                 "analytic_bytes_ratio")


def _analytic_fields(rows):
    return [{k: r[k] for k in ANALYTIC_KEYS if k in r} for r in rows
            if "analytic_bytes" in r or "analytic_bytes_ratio" in r]


@pytest.mark.parametrize("shapes", ["smoke", "default", "strassen"])
def test_analytic_rows_and_checks_equal_reference(monkeypatch, shapes):
    sweeps = {"smoke": (traffic.SMOKE_SHAPES, [
                  (traffic.DEFAULT_W, traffic.TRAFFIC_KINDS),
                  (15, ("fused_mm2", "staged_mm2")),
                  (20, ("fused_d2", "staged_d2")),
                  (traffic.STRASSEN_W, traffic.STRASSEN_KINDS)]),
              "default": (traffic.DEFAULT_SHAPES, [
                  (traffic.DEFAULT_W, traffic.TRAFFIC_KINDS),
                  (15, ("fused_mm2", "staged_mm2")),
                  (20, ("fused_d2", "staged_d2"))]),
              "strassen": (traffic.STRASSEN_SHAPES, [
                  (traffic.STRASSEN_W, traffic.STRASSEN_KINDS)])}
    shape_set, runs = sweeps[shapes]
    all_got, all_ref = [], []
    for w, kinds in runs:
        got = traffic.analytic_rows(shape_set, w=w, kinds=kinds)
        ref = _ref_rows(monkeypatch, shape_set, w=w, kinds=kinds)
        assert _analytic_fields(got) == _analytic_fields(ref)
        all_got += got
        all_ref += ref
    # the reference's verdicts on its (stub-measured) rows, and on the
    # analytic rows alone, are the port's
    assert traffic.traffic_checks(all_ref) == \
        ref_traffic.traffic_checks(all_ref)
    checks = traffic.traffic_checks(all_got)
    assert checks == ref_traffic.traffic_checks(all_got)
    ratio = [c for c in checks if c[0].startswith("analytic bytes ratio")]
    assert all(ok for _, ok, _ in ratio)
    assert bool(ratio) == any(k == traffic.STRASSEN_KINDS for _, k in runs)
    assert checks[0][1] is False and checks[0][2] == "0 measured, 0 errors"


def test_analytic_claims_in_every_window():
    # the committed Strassen claim: 7 fused sub-GEMMs move fewer bytes
    for shapes in (traffic.STRASSEN_SHAPES, traffic.SMOKE_SHAPES):
        rows = traffic.analytic_rows(shapes, w=traffic.STRASSEN_W,
                                     kinds=traffic.STRASSEN_KINDS)
        ratios = [r["analytic_bytes_ratio"] for r in rows
                  if "analytic_bytes_ratio" in r]
        assert len(ratios) == len(shapes)
        assert all(0 < x < 1.0 for x in ratios)
    # the paper's claim in the model: fused below staged in every window
    for (shape, bk) in traffic.SMOKE_SHAPES + traffic.DEFAULT_SHAPES:
        tiles = (min(128, shape[0]), min(128, shape[2]), bk)
        for fk, sk in traffic.FUSED_PAIRS:
            w = dict(traffic.EXTENDED_KINDS).get(fk, traffic.DEFAULT_W)
            assert traffic.analytic_bytes(fk, shape, w=w, tiles=tiles) < \
                traffic.analytic_bytes(sk, shape, w=w, tiles=tiles)


@pytest.mark.parametrize("fn", ["measure_costs", "measure_plan_bytes",
                                "traffic_rows"])
def test_measured_side_raises_with_reason(fn):
    with pytest.raises(NotImplementedError, match="ncu"):
        getattr(traffic, fn)(None, None, None)


# ---------------------------------------------------------------------------
# Complexity, area, efficiency, dispatch helpers
# ---------------------------------------------------------------------------

NS = (1, 2, 4, 8, 16, 32)
CX_WIDTHS = (1, 2, 3, 8, 12, 16, 24, 32, 40, 48, 56, 64)


def _counts(c):
    return dict(c.counts)


@pytest.mark.parametrize("name", ["mm_complexity", "kmm_complexity",
                                  "ksmm_complexity"])
@pytest.mark.parametrize("p", [None, 4])
def test_matrix_complexity_equal_reference(name, p):
    fn, ref = getattr(cx, name), getattr(ref_cx, name)
    for n in NS:
        for w in CX_WIDTHS:
            for d in (16, 64):
                got, want = fn(n, w, d, p=p), ref(n, w, d, p=p)
                assert _counts(got) == _counts(want), (name, n, w, d, p)
                assert got.total() == want.total()
                assert got.by_kind() == want.by_kind()
                assert got.total_of(cx.ADD) == want.total_of(ref_cx.ADD)
    assert _counts(fn(4, 16, 8, w_a=7)) == _counts(ref(4, 16, 8, w_a=7))


def test_ksm_complexity_equal_reference():
    for n in NS:
        for w in CX_WIDTHS:
            assert _counts(cx.ksm_complexity(n, w)) == \
                _counts(ref_cx.ksm_complexity(n, w)), (n, w)


@pytest.mark.parametrize("name", ["mm_arith", "ksmm_arith", "kmm_arith"])
def test_closed_forms_equal_reference(name):
    for n in NS:
        for d in (1, 16, 64, 256):
            assert getattr(cx, name)(n, d) == getattr(ref_cx, name)(n, d)


@pytest.mark.parametrize("name", ["area_add", "area_ff", "area_mult"])
def test_area_primitives_equal_reference(name):
    for w in range(1, 129):
        assert getattr(area, name)(w) == getattr(ref_area, name)(w)
    assert area.FF_RATIO == ref_area.FF_RATIO


@pytest.mark.parametrize("name", ["area_mm1", "area_ksmm", "area_kmm"])
def test_area_architectures_equal_reference(name):
    fn, ref = getattr(area, name), getattr(ref_area, name)
    for w in (8, 12, 16, 24, 32, 40, 48, 56, 64):
        for x, y, p in ((64, 64, 4), (32, 128, 2), (128, 128, 8)):
            if name == "area_mm1":
                assert fn(w, x=x, y=y, p=p) == ref(w, x=x, y=y, p=p)
                continue
            for n in (1, 2, 4, 8):
                assert fn(n, w, x=x, y=y, p=p) == ref(n, w, x=x, y=y, p=p)
    for w2 in (16, 24, 64):
        assert area.area_accum(w2, w_a=6, p=4) == \
            ref_area.area_accum(w2, w_a=6, p=4)
    for n in (1, 2, 4, 8, 16):
        for w in CX_WIDTHS:
            assert area.area_ksm(n, w) == ref_area.area_ksm(n, w)


def test_area_levels_and_au_efficiency_equal_reference():
    for w in range(4, 65, 4):
        for max_r in (2, 4):
            assert area.best_kmm_levels(w, max_r=max_r) == \
                ref_area.best_kmm_levels(w, max_r=max_r)
        for arch, n in (("mm1", None), ("ksmm", 2), ("ksmm", None),
                        ("kmm", None), ("kmm", 4)):
            got = area.au_efficiency_vs_mm1(arch, w, n=n)
            want = ref_area.au_efficiency_vs_mm1(arch, w, n=n)
            assert (got.arch, got.w, got.relative) == \
                (want.arch, want.w, want.relative)
    with pytest.raises(ValueError):
        area.au_efficiency_vs_mm1("nope", 8)


@pytest.mark.parametrize("m", [4, 8, 16])
def test_efficiency_and_dispatch_helpers_equal_reference(m):
    widths = range(1, 4 * m + 1)
    for w in widths:
        assert dispatch.conv_recursion(w, m) == \
            ref_dispatch.conv_recursion(w, m)
        assert dispatch.conv_mults_per_product(w, m) == \
            ref_dispatch.conv_mults_per_product(w, m)
        if ref_dispatch.kmm_levels_needed(w, m) is None:
            continue
        assert dispatch.efficiency_roof(w, m) == \
            ref_dispatch.efficiency_roof(w, m)
        assert dispatch.select_mode(w, m).mults_per_product == \
            ref_dispatch.select_mode(w, m).mults_per_product
        for arch in ("mm", "kmm", "ffip", "ffip_kmm"):
            assert efficiency.roof(arch, w, m) == ref_eff.roof(arch, w, m)
            assert efficiency.precision_scalable_roof(arch, w, m) == \
                ref_eff.precision_scalable_roof(arch, w, m)
        meas = dict(n_w_products=1000 * 64 ** 3, w=w, m=m,
                    cycles=3 * 64 * 1000, n_multipliers=64 * 64)
        assert efficiency.Measured(**meas).efficiency == \
            ref_eff.Measured(**meas).efficiency
    got = [(p.mode.value, p.passes, p.digits, p.recursion)
           for p in dispatch.schedule(list(widths), m)]
    want = [(p.mode.value, p.passes, p.digits, p.recursion)
            for p in ref_dispatch.schedule(list(widths), m)]
    assert got == want
    assert efficiency.gops(3e9, 1.5) == ref_eff.gops(3e9, 1.5)
    with pytest.raises(ValueError):
        efficiency.roof("nope", 8, m)


# The paper's claims (tests/test_complexity.py), on the port.

def test_paper_claims_hold_on_the_port():
    d = 64
    for w in (16, 32):
        assert cx.mm_complexity(2, w, d).total() == cx.mm_arith(2, d)
        assert cx.kmm_complexity(2, w, d).total() == cx.kmm_arith(2, d)
        assert cx.ksmm_complexity(2, w, d).total() == cx.ksmm_arith(2, d)
    for n in (2, 4, 8, 16, 32):
        assert cx.ksmm_arith(n, d) / cx.kmm_arith(n, d) > 1.75
    assert cx.kmm_arith(2, d) < cx.mm_arith(2, d)
    flat, pre = cx.mm_complexity(1, 8, d), cx.mm_complexity(1, 8, d, p=4)
    wa = math.ceil(math.log2(d))
    assert pre.counts[("ADD", 16 + wa)] == flat.counts[("ACCUM", 16 + wa)] / 4
    assert pre.total() == flat.total()
    assert area.area_kmm(2, 24) < area.area_mm1(24) < area.area_ksmm(2, 24)
    for w in (8, 16, 24, 32):
        assert area.best_kmm_levels(w) == 1
    for w in (40, 48, 56):
        assert area.best_kmm_levels(w) == 2
    assert efficiency.roof("kmm", 32, 8) == pytest.approx((4 / 3) ** 2)
    assert efficiency.precision_scalable_roof("kmm", 12, 8) == \
        pytest.approx(4 / 3)
    m = efficiency.Measured(n_w_products=1000 * 64 ** 3, w=12, m=8,
                            cycles=1000 * 3 * 64, n_multipliers=64 * 64)
    assert m.efficiency == pytest.approx(4 / 3)
