"""session.plan_ms: the mean host ms per answered query in the serving
layer's parse, plan and prune (the benchmark's span around
ServingLayer.plan_entry)."""

def read(r):
    spans = r.span_s.get("session.plan", [])
    if not spans or not r.answered:
        return None
    return 1000.0 * sum(spans) / r.answered
