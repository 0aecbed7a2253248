"""Mean ms from a request's issue to the start of its ``prefill`` span,
over the requests issued in the part of the window the profiler does not
slow."""


def read(rec):
    lo, hi = rec.untraced
    issue = {log.rid: log.issue for log in rec.logs}
    waits = [s.t0 - issue[s.args["rid"]] for s in rec.spans
             if s.name == "prefill" and lo <= issue[s.args["rid"]] <= hi]
    return 1e3 * sum(waits) / len(waits) if waits else None
