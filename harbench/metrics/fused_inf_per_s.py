"""Units of work completed in the window (windows served, or samples of optimizer
steps) over the window's seconds, on the host's clock; the window closes when the last
work issued before its deadline completes."""


def read(run):
    return run.window.rate()
