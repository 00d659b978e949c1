"""ba_ms_per_update: a CUDA event pair around BATrack.update (a subclass in
the harness), mean over the window's updates, initialisation included."""


def read(run):
    ms = run.pairs.get("ba_update")
    return sum(ms) / len(ms) if ms else None
