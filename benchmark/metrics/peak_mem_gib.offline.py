"""Peak device memory of the run (set-up and window), GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30
