"""Liquid encodings: bit-plane primitives and decimals, linear and delta
integers, ALP floats, FSST-backed string and fixed-width dictionaries,
shredded variant (JSON) columns, their squeezed forms and Liquid IPC."""
