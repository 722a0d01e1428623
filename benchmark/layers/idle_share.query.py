"""idle_share.query: the share of the traced window in which the card ran
no kernel, memcpy or memset (100 less the union of their intervals over
the window), in percent."""

from measure import idle_share


def read(ctx: dict):
    return idle_share(ctx["trace"]["busy_s"], ctx["trace"]["window_s"])
