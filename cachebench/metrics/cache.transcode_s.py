"""cache.transcode_s (s): the host clock around set-up's `ensure_cached` of
every row group of the columns the cell's queries name."""


def read(run):
    return run.transcode_s
