"""Env steps completed over all the time of the window: whole episodes of
all envs, back to back; the episode still running when the window's time
is up is finished and counted."""

UNIT, SOURCE = "env-steps/s", "host_clock"


def read(ctx):
    if "env_steps" not in ctx.work:
        return None
    return ctx.work["env_steps"] / ctx.work["window_s"]
