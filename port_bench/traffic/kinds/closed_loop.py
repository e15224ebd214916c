"""Closed loop: ``clients`` callers, each sends its next request when its
last one has finished.

Parameters: ``clients``; ``pool``, how many sizes the loop cycles
through (default one per client); the lengths (``generator.Traffic.sizes``);
``residual_start``: each client's first request starts at a share u of
its output, its prompt carrying those u tokens, the shares one stratified
set shuffled once, and the window opens when every first request has its
first token.
"""

CLOSED = True


def setup(t) -> None:
    t.clients = int(t.params["clients"])
    t.pool = t.permuted(t.sizes(int(t.params.get("pool", t.clients))), 1)
    t.pool_at = 0


def _next_size(t):
    size = t.pool[t.pool_at % len(t.pool)]
    t.pool_at += 1
    return size


def first_requests(t) -> list:
    """Each client's first request, the residual start applied."""
    shares = None
    if t.params.get("residual_start"):
        shares = t.permuted(
            [(i + 0.5) / t.clients for i in range(t.clients)], 3)
    reqs = []
    for c in range(t.clients):
        prompt, out = _next_size(t)
        done = 0 if shares is None else min(out - 1, int(shares[c] * out))
        reqs.append(t.request(prompt + done, out - done, client=c))
    return reqs


def next_request(t, client: int):
    """The next request of ``client``."""
    prompt, out = _next_size(t)
    return t.request(prompt, out, client=client)
