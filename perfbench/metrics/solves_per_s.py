"""QPs that ended solved (solved or solved inaccurate) in the window,
over the window's seconds: every lane of every step counted, an
unsolved lane not."""


def read(ctx):
    solved = getattr(ctx["cell"], "solved_count", None)
    return solved() / ctx["window_s"] if solved else None
