"""qps (queries/s): the queries completed in the window over the time from
the window's start to the last completion."""


def read(run):
    return run.completed / run.window_s
