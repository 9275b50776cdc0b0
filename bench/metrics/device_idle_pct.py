"""The traced window's share in which nothing ran on the card: the window
less the union of the activity intervals, over the window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
