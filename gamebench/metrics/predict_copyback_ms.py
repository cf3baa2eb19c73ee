"""The predictor's copies back per request: the mean, over the traced
window's requests, of the time in ``mmg.predict.copy_back`` (the answer,
the turn count and the messages to the host, with the wait for the
conversation) inside each ``mmg.predict``. None unless the calls match
the harness's request marks one to one."""

from gamebench.spans import per_request_ms


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return per_request_ms(ctx, "mmg.predict.copy_back")
