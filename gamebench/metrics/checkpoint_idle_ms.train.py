"""The mean time per checkpoint (``mmg.driver.checkpoint``, periodic and
best, whole inside the traced training window) in which no operation ran
on the card: the stall the write causes, not its length, which holds the
wait for the steps queued before its copies to the host."""

from gamebench.spans import mean_idle_ms


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return mean_idle_ms(ctx, "mmg.driver.checkpoint")
