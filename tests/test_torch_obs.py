"""The port's observability plane against the JAX package's, on the CPU.

Both packages get the same records under a ``LogicalClock``: the Chrome
trace documents (``chrome_trace`` / ``write_trace``, the flight recorder's
``dump``) must be equal as JSON and byte for byte on disk, and the markdown
report of either document the same.  ``SLOTracker`` / ``SLOEngine`` fed the
same samples and histograms must give equal statuses, burn rates, breach
counts, trace instants and exported gauges; ``RegressionDetector`` fed the
same span stream must flag and attribute the same chunks.  Plus the
``python -m repro_torch.obs.report`` command line.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import repro.obs as jobs
import repro.obs.detect as jdetect
import repro.obs.report as jreport
import repro.obs.slo as jslo
import repro_torch.obs as tobs
import repro_torch.obs.detect as tdetect
import repro_torch.obs.report as treport
import repro_torch.obs.slo as tslo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = types.SimpleNamespace(obs=jobs, slo=jslo, detect=jdetect, report=jreport)
TORCH = types.SimpleNamespace(obs=tobs, slo=tslo, detect=tdetect,
                              report=treport)


def _instants(tracer):
    return [(i.name, i.t, i.tid, dict(i.args or {})) for i in tracer.instants]


# ---------------------------------------------------------------------------
# trace export and the flight recorder
# ---------------------------------------------------------------------------

def _script(pkg, max_events=64):
    """One fixed run of spans (nested, on a labelled second track), instants
    with arguments of every kind the export handles, counter samples, a
    saturated buffer and a registry, under a logical clock."""
    o = pkg.obs
    clk = o.LogicalClock()
    ring = o.FlightRecorder(capacity=16, metrics_capacity=2)
    tracer = o.Tracer(clock=clk, max_events=max_events, recorder=ring)
    reg = o.MetricsRegistry()
    side = tracer.alloc_track("shard-host-1")
    for c in range(12):
        with tracer.span("chunk", m=16, degree=3 + c % 2):
            for stage in ("route", "expand_panes", "close"):
                with tracer.span(stage):
                    clk.advance(0.25 + 0.125 * (c % 3))
            tracer.record_span("prepare", clk.now() - 0.5, clk.now(),
                               tid=side, depth=0, chunk=c)
            clk.advance(0.0625)
        tracer.counter("queue", depth=c % 5, occupancy=0.5 * c)
        reg.histogram("chunk_s").record(0.001 * (c + 1))
        reg.counter("chunks").inc()
        if c % 4 == 3:
            tracer.instant("resize", n_old=3, n_new=4, ok=True, why="load",
                           rows=[1, 2], frac=0.75)
            ring.sample_metrics(reg, t=clk.now())
    reg.gauge("g").set(2.5)
    return tracer, ring, reg


def test_chrome_trace_equals_the_reference():
    (jt, _, jreg), (tt, _, treg) = _script(JAX), _script(TORCH)
    assert tt.dropped == jt.dropped > 0
    for kw in ({}, {"process_name": "run", "extra": {"seed": 3}}):
        jdoc = jobs.chrome_trace(jt, registry=jreg, **kw)
        tdoc = tobs.chrome_trace(tt, registry=treg, **kw)
        assert json.dumps(tdoc) == json.dumps(jdoc)
    names = {e["args"]["name"] for e in tdoc["traceEvents"]
             if e["name"] == "thread_name"}
    assert "shard-host-1" in names and len(names) == 2
    assert tdoc["otherData"]["metrics"]["counters"]["obs.tracer.dropped_spans"] > 0


def test_write_trace_and_metrics_files_equal_the_reference(tmp_path):
    (jt, _, jreg), (tt, _, treg) = _script(JAX), _script(TORCH)
    jobs.write_trace(str(tmp_path / "j.json"), jt, registry=jreg)
    tobs.write_trace(str(tmp_path / "t.json"), tt, registry=treg)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    jobs.write_metrics(str(tmp_path / "jm.json"), jreg)
    tobs.write_metrics(str(tmp_path / "tm.json"), treg)
    assert (tmp_path / "tm.json").read_bytes() == \
        (tmp_path / "jm.json").read_bytes()


def test_flight_recorder_dump_equals_the_reference(tmp_path):
    """The ring keeps the newest events of a saturated tracer; its dump is
    a loadable Chrome trace, equal to the reference's, with the metrics
    ring and a final snapshot riding along."""
    (jt, jring, jreg), (tt, tring, treg) = _script(JAX, 8), _script(TORCH, 8)
    assert tt.dropped > 0 and len(tring.spans) == 16
    jdoc = jring.dump(str(tmp_path / "j.json"), registry=jreg)
    tdoc = tring.dump(str(tmp_path / "t.json"), registry=treg)
    assert json.dumps(tdoc) == json.dumps(jdoc)
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc == json.loads((tmp_path / "j.json").read_text())
    assert doc["otherData"]["metrics_ring"] and \
        len(doc["otherData"]["metrics_ring"]) == 2
    assert doc["otherData"]["metrics"]["gauges"]["g"] == 2.5
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert max(e["ts"] + e["dur"] for e in spans) == \
        pytest.approx(tt.clock.now() * 1e6)


@pytest.mark.parametrize("anchor", ["chunk", "tick"])
def test_report_renders_like_the_reference(tmp_path, anchor):
    """The same markdown for the same document, whichever package wrote it
    (``tick`` is absent: the no-anchor branch)."""
    (jt, _, jreg), (tt, _, treg) = _script(JAX), _script(TORCH)
    jdoc = jobs.chrome_trace(jt, registry=jreg)
    tdoc = tobs.chrome_trace(tt, registry=treg)
    want = jreport.render(jdoc, anchor=anchor)
    assert treport.render(tdoc, anchor=anchor) == want
    assert treport.render(jdoc, anchor=anchor) == want
    assert "## Events" in want and "## Counters" in want


def test_report_command_line(tmp_path):
    tt, _, treg = _script(TORCH)
    path = tmp_path / "trace.json"
    tobs.write_trace(str(path), tt, registry=treg)
    out = tmp_path / "report.md"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(path), "-o",
         str(out), "--title", "t"], capture_output=True, text=True,
        timeout=120, env=env)
    assert run.returncode == 0, run.stderr
    assert out.read_text() == jreport.render(
        jreport.load(str(path)), title="t")


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

SPEC = dict(name="decode", objective=0.05, q=0.9, compliance=0.9,
            short_window=4, long_window=16, fast_burn=4.0, slow_burn=1.5,
            throughput_floor=10.0)


def _slo_run(pkg, seed):
    """A tracker fed raw samples and histogram deltas in turns, with load
    that drifts from healthy into a breach and back; every status, then the
    board's export."""
    o, slo = pkg.obs, pkg.slo
    rng = np.random.default_rng(seed)
    tracer = o.Tracer(clock=o.LogicalClock(), recorder=None)
    board = slo.SLOEngine(tracer=tracer)
    tr = board.add(slo.SLOSpec(**SPEC))
    other = board.add(slo.SLOSpec(name="prefill", objective=0.2))
    hist = o.Histogram()
    statuses = []
    for tick in range(60):
        scale = 0.03 if (tick // 20) % 2 == 0 else 0.09
        xs = rng.gamma(2.0, scale / 2.0, size=int(rng.integers(1, 5)))
        if tick % 3:
            for x in xs:
                tr.observe(float(x))
        else:
            for x in xs:
                hist.record(float(x))
            tr.ingest_histogram(hist)
        other.observe(float(xs[0]) * 3)
        tput = float(rng.uniform(5, 50)) if tick % 7 == 0 else None
        statuses.append(dataclasses.asdict(tr.evaluate(throughput=tput)))
        tracer.clock.advance(1.0)
    statuses.append({k: dataclasses.asdict(v)
                     for k, v in board.evaluate_all().items()})
    reg = o.MetricsRegistry()
    board.export(reg)
    return dict(statuses=statuses, breaches=tr.breaches,
                burn=[tr.burn_rate(w) for w in (1, 4, 16, 64)],
                budget=tr.budget_remaining(), p=tr.percentile(),
                instants=_instants(tracer), export=reg.snapshot(),
                snapshot=board.snapshot())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_tracker_and_engine_equal_the_reference(seed):
    want = _slo_run(JAX, seed)
    got = _slo_run(TORCH, seed)
    assert got == want
    verdicts = {s["verdict"] for s in want["statuses"][:-1]}
    assert {"ok", "breach"} <= verdicts and want["breaches"] >= 1
    assert any(name == "slo.breach" for name, *_ in want["instants"])


def test_slo_spec_validation_matches_the_reference():
    bad = [dict(objective=0.0), dict(objective=1.0, compliance=1.0),
           dict(objective=1.0, q=0.0),
           dict(objective=1.0, short_window=9, long_window=4),
           dict(objective=1.0, fast_burn=1.0, slow_burn=2.0)]
    for kw in bad:
        for slo in (jslo, tslo):
            with pytest.raises(ValueError):
                slo.SLOSpec(name="x", **kw)


# ---------------------------------------------------------------------------
# regression detection
# ---------------------------------------------------------------------------

STAGES = ("route", "expand_panes", "dedup_cells", "reduce_by_cell",
          "table_update", "close")


def _detect_run(pkg, seed, every):
    """Chunks of six stage spans inside a ``chunk`` anchor, with noise, a
    stage made 4x slower at a few chunks and a sustained shift later; the
    detector consumes every ``every`` chunks."""
    o = pkg.obs
    rng = np.random.default_rng(seed)
    clk = o.LogicalClock()
    tracer = o.Tracer(clock=clk, recorder=None)
    reg = o.MetricsRegistry()
    det = pkg.detect.RegressionDetector(tracer, stages=STAGES, window=16,
                                        min_samples=6, registry=reg)
    flagged = []
    for c in range(70):
        t0 = clk.now()
        for j, stage in enumerate(STAGES):
            d = 1.0 + 0.5 * j + float(rng.normal(0, 0.02))
            if (c in (20, 33) and j == 4) or (c >= 50 and j == 5):
                d *= 4.0
            s0 = clk.now()
            clk.advance(d)
            tracer.record_span(stage, s0, clk.now(), tid=0, depth=1)
        clk.advance(0.1)
        tracer.record_span("chunk", t0, clk.now(), tid=0)
        if c % every == every - 1:
            flagged += [dataclasses.asdict(r) for r in det.consume()]
    flagged += [dataclasses.asdict(r) for r in det.consume()]
    return dict(flagged=flagged, instants=_instants(tracer),
                counters=reg.snapshot()["counters"],
                medians={k: b.median() for k, b in det.baselines.items()})


@pytest.mark.parametrize("seed,every", [(0, 1), (1, 7)])
def test_regression_detector_equals_the_reference(seed, every):
    want = _detect_run(JAX, seed, every)
    got = _detect_run(TORCH, seed, every)
    assert got == want
    stages = {(r["chunk"], r["stage"]) for r in want["flagged"]}
    assert (20, "table_update") in stages and (50, "close") in stages


def test_stage_baseline_equals_the_reference():
    xs = [1.0, 1.0, 1.1, 0.9, 1.0, 5.0, 1.05, 0.95]
    got, want = tdetect.StageBaseline(8, 4), jdetect.StageBaseline(8, 4)
    for x in xs:
        got.add(x)
        want.add(x)
        assert got.ready == want.ready
    assert (got.median(), got.mad(), got.sigma(), got.score(3.0)) == \
        (want.median(), want.mad(), want.sigma(), want.score(3.0))
