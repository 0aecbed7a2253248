"""Closed-loop clients against ``serving.engine.ServingEngine``.

Each of ``clients`` clients sends its next request when its last one has
all its tokens; requests come from ``bench.workload.Requests``.  The engine
runs ``slots`` decode slots under ``policy``, with caches of ``s_max``
positions.  A client sees its tokens when the engine's ``step`` returns,
so each token is stamped with the end of the tick that made it, and a new
request is issued at that time too.

Set-up loads the seeded weights and runs the loop until every client's
first request is done: that builds the kernels, warms the shapes (prefills
at the mix's lengths, decodes at every slot) and leaves the loop in its
steady state, the clients' requests at every stage.  The window follows
without a break.  A window that issued the first requests itself would hold
in its tails their wait behind each other's prefills: the round's first
tick, ``notes["cold_tick_s"]``.  After it a sample of the requests finished
inside it, drawn from the seed with the one of most served tokens in it, is
checked against the reference's logits, once the program's state is freed.
"""

from __future__ import annotations

import types

from bench import compare, model as bm, window, workload
from bench.drivers import Context, Outcome, now, peak_bytes, release, \
    reset_peak, sync
from bench.reference.serve import served_logits
from bench.trace import Profiler


class _Both:
    """Enter a profiler range and a tracer span as one."""

    __slots__ = ("a", "b")

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __enter__(self):
        self.a.__enter__()
        self.b.__enter__()
        return self

    def __exit__(self, *exc):
        self.b.__exit__(*exc)
        self.a.__exit__(*exc)


def bench_tracer(prof: Profiler):
    """The program's ``Tracer`` that also opens a profiler range for each
    span and notes the slots' cache lengths as each decode step starts."""
    from repro_torch.obs.trace import Tracer

    class BenchTracer(Tracer):
        def __init__(self):
            super().__init__(recorder=None)
            self.engine = None
            #: per decode step: every slot's cache length and the active
            #: slots, as the step starts
            self.decodes = []

        def span(self, name, **args):
            if name == "decode":
                self.decodes.append((self.engine.lengths.copy(),
                                     sorted(self.engine.active)))
            return _Both(prof.range(name), super().span(name, **args))

    return BenchTracer()


def tick_summary(t0, ticks):
    """Mean seconds a tick, traced and not."""
    out, last = {}, t0
    for t, traced in ticks:
        out.setdefault("traced" if traced else "untraced", []).append(t - last)
        last = t
    return {k: [len(v), sum(v) / len(v)] for k, v in out.items()}


def sample(done, seed: int, n: int):
    """``n`` requests of ``done`` drawn from the seed, with the one of most
    served tokens (then the longest prompt) among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.generated), len(r.prompt),
                                       -r.rid))
    rest = [r for r in done if r is not longest]
    pick = workload.rng(seed, 3).permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def run(ctx: Context) -> Outcome:
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Request, ServingEngine

    tr, dev, cfg = ctx.traffic, ctx.device, ctx.cfg
    mcfg = bm.port_config(cfg)
    model = T.Transformer(mcfg, device=dev)
    bm.load_into(model, cfg, ctx.seed)
    prof = Profiler(ctx.trace, dev, tr["trace_seconds"])
    tracer = bench_tracer(prof) if ctx.trace else None
    engine = ServingEngine(mcfg, model, num_slots=tr["slots"],
                           s_max=tr["s_max"], policy=tr["policy"],
                           tracer=tracer, device=dev)
    if tracer is not None:
        tracer.engine = engine
    requests = workload.Requests(tr, ctx.seed, cfg["vocab_size"])
    logs, inflight, done = [], {}, []

    def issue(t):
        spec = requests(len(logs))
        req = Request(rid=spec.rid, prompt=spec.prompt,
                      max_new_tokens=spec.max_new)
        log = window.RequestLog(spec.rid, t, len(spec.prompt), spec.max_new)
        logs.append(log)
        inflight[spec.rid] = (req, log)
        engine.submit(req)

    #: the window's start, and whether a request issued in it has two
    #: tokens yet (a window has at least one time to first token and one
    #: gap between tokens)
    state = {"t0": float("inf"), "sampled": False}

    def tick():
        with prof.range("step"):
            engine.step()
        t = now()
        with prof.range("client"):
            for rid, (req, log) in list(inflight.items()):
                new = len(req.generated) - len(log.token_times)
                log.token_times += [t] * new
                if log.issue >= state["t0"] and len(log.token_times) > 1:
                    state["sampled"] = True
                if req.done:
                    del inflight[rid]
                    req.logits = None
                    done.append((t, req))
                    issue(t)
        return t

    t_issue = now()
    for _ in range(tr["clients"]):
        issue(t_issue)
    cold = tick()
    while any(rid < tr["clients"] for rid in inflight):
        tick()
    sync(dev)

    t0 = state["t0"] = now()
    setup_s = t0 - ctx.t_start
    reset_peak(dev)
    ticks = []
    while True:
        prof.maybe_start(now(), t0, ctx.seconds)
        t = tick()
        ticks.append((t, prof.active()))
        prof.tick(t)
        if t - t0 >= ctx.seconds and state["sampled"] and prof.complete():
            break
    t_end = t
    prof.stop(now())
    lo, hi = prof.stretch
    peak = peak_bytes(dev)
    nums = window.serve_numbers(logs, t0, t_end)
    trace = prof.result()

    finished = [req for t, req in done if t0 < t <= t_end]
    picked = sample(finished, ctx.seed, tr["sample_requests"])
    spans = list(tracer.spans) if tracer else []
    counters = list(tracer.counters) if tracer else []
    decodes = list(tracer.decodes) if tracer else []
    del engine, model, inflight, tracer
    release(dev)
    t_ref = now()
    modes = ("float32", "fp8") if ctx.control else ("float32",)
    both = served_logits(cfg, ctx.seed, [(r.prompt, r.generated)
                                         for r in picked], dev, modes)
    gaps = compare.served_gaps([r.generated for r in picked], both[0])
    checks = compare.serve_checks(gaps)
    notes = {"reference_s": now() - t_ref, "readings": checks}
    if ctx.control:
        notes["control"] = compare.serve_checks(
            compare.lower_precision_gaps(both[0], both[1]))
    record = types.SimpleNamespace(
        cfg=cfg, traffic=tr, trace=trace,
        profiled=prof.stretch, untraced=(t0, prof.started or t_end),
        window=(t0, t_end), spans=spans, counters=counters,
        decodes=decodes, logs=logs)
    if trace is not None:
        notes["traced"] = {
            "prefills": len([x for x in spans if x.name == "prefill"
                             and lo <= x.t0 and x.t1 <= hi]),
            "ticks": prof.counted, "by_class": trace.by_class()}
    notes["cold_tick_s"] = cold - t_issue
    notes["tick_s"] = tick_summary(t0, ticks)
    return Outcome(
        numbers={k: nums[k] for k in ("serve_tokens_per_s", "ttft_p95_ms",
                                      "itl_p95_ms")} | {"setup_s": setup_s},
        attempted=nums["attempted"], failed=nums["failed"],
        memory_peak_bytes=peak,
        checks=checks,
        record=record,
        notes={**notes, "window_s": t_end - t0,
               "requests_in_window": nums["requests_in_window"],
               "gaps_in_window": nums["gaps_in_window"],
               "finished_in_window": len(finished),
               "checked_requests": len(picked),
               "checked_tokens": sum(len(r.generated) for r in picked),
               "gap_by_request": [round(max(g), 4) for g in gaps if g]})
