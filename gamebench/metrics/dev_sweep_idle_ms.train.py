"""The mean time per dev sweep (``mmg.driver.dev_sweep``, whole inside
the traced training window) in which no operation ran on the card: the
stall the sweep causes, not its length, which holds the wait for the
steps queued before it."""

from gamebench.spans import mean_idle_ms


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return mean_idle_ms(ctx, "mmg.driver.dev_sweep")
