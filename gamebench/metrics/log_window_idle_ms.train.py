"""The mean time per log window (``mmg.driver.log_window``: the copy of
the window's payload to the host and its printing, whole inside the
traced training window) in which no operation ran on the card: the stall
the window causes, not its length, which is mostly the wait for the
steps queued before its copy."""

from gamebench.spans import mean_idle_ms


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return mean_idle_ms(ctx, "mmg.driver.log_window")
