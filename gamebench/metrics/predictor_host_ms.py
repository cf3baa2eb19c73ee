"""The predictor's host time per request: the mean, over the traced
window's requests, of the harness's span around each ``predict`` less the
device time of the operations that started inside it."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    tr = ctx["trace"]
    spans = tr.marks.get("gamebench.request", [])
    if not spans:
        return None
    host = [(b - a) * 1e-9 - tr.device_seconds_between(a, b)
            for a, b in spans]
    return 1e3 * sum(host) / len(host)
