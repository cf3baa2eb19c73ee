"""The predictor's tower call per request: the mean, over the traced
window's requests, of the time in ``mmg.predict.tower`` (on a card the
host's side of the tower's graph replay) inside each ``mmg.predict``.
None where the program has no such span, or unless the calls match the
harness's request marks one to one."""

from gamebench.spans import per_request_ms, whole

SPAN = "mmg.predict.tower"


def read(ctx):
    if ctx["kind"] != "serve_pixels" or not len(whole(ctx["trace"], SPAN)):
        return None
    return per_request_ms(ctx, SPAN)
