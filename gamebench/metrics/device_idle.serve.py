"""The share of the traced serving window in which no operation ran
on the card: one less the union of the device's operations over the
window."""


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
