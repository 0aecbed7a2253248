"""Mean share of the decode slots that hold a request, from the engine's
``serving.load`` counter at each tick of the window, in percent."""


def read(rec):
    w0, w1 = rec.window
    loads = [c.values["active"] / c.values["slots"] for c in rec.counters
             if c.name == "serving.load" and w0 <= c.t <= w1]
    return 100.0 * sum(loads) / len(loads) if loads else None
