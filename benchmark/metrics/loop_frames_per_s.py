"""loop_frames_per_s: the frames the stream completed in the window (a frame is
complete once its call's work has finished on the card), over the window's
seconds."""


def read(run):
    end_ms = run.seconds * 1e3
    done = sum(1 for ms in run.completions if ms <= end_ms)
    return done / run.seconds if done else None
