"""The predictor's inputs per request: the mean, over the traced
window's requests, of the time in ``mmg.predict.input`` (the features
and context to the card and the Philox uniforms) inside each
``mmg.predict``. None unless the calls match the harness's request marks
one to one."""

from gamebench.spans import per_request_ms


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    return per_request_ms(ctx, "mmg.predict.input")
