"""Share of a profiled slice of the serving window in which no device
operation ran: 100 - device busy / wall (`harness.profile_slice`)."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
