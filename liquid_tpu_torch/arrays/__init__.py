"""Liquid encodings: bit-plane primitives and decimals, linear and delta
integers, ALP floats, FSST-backed string and fixed-width dictionaries,
shredded variant (JSON) columns, their squeezed forms and Liquid IPC."""
from liquid_tpu_torch.arrays.base import BLOCK_ROWS, CMP_OPS  # noqa: F401
