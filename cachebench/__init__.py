"""The benchmark of `liquid_tpu_torch`: warm SQL traffic on one card,
driven through the port's public session API (`python -m cachebench.run`).
"""
