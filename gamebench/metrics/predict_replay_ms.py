"""The predictor's conversation call per request: the mean, over the
traced window's requests, of the time in ``mmg.predict.replay`` (on a
card the host's side of one graph replay) inside each ``mmg.predict``.
None unless the calls match the harness's request marks one to one."""

from gamebench.spans import per_request_ms


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return per_request_ms(ctx, "mmg.predict.replay")
