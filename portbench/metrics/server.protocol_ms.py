"""server.protocol_ms: per answered query, the client's wall (POST to
last page) less the coordinator's elapsedTimeMillis on its last page,
as a mean in ms: what the statement protocol and its polling add."""


def read(r):
    gaps = [q.wall_s * 1000.0 - q.elapsed_ms for q in r.queries if q.ok]
    return sum(gaps) / len(gaps) if gaps else None
