"""Image tokens generated in the window over the window's seconds, all
slots together (host clock; for Lumina the grid's tokens, row ends
included)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
