"""setup_s (s): process start to window start -- imports, CUDA init,
kernel loads or builds, `register_parquet`, transcode and the warm pass --
without the data generation, which is the benchmark's own work."""


def read(run):
    return run.setup_s
