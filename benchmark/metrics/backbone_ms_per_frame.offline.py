"""Device ms launched inside the backbone's range (the C4 body with the
stem), per frame it computed (MEGA: the local and the global frame of each
lane; FGFA: each lane's new frame)."""


def read(ctx):
    ms = ctx["trace"]["range_ms_per_step"].get("backbone")
    return None if not ms else ms / ctx["frames_per_step"]
