"""frames_per_s: shown frames whose planes reached host memory inside the
window, over the window's seconds, all streams together (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.frames_window / run.window_s
