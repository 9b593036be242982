"""executor.dtoh_per_query: Memcpy DtoH activities in the window's
trace per answered query; each is a host sync that exposes host time to
the card."""


def read(r):
    return r.dtoh / r.answered if r.answered else None
