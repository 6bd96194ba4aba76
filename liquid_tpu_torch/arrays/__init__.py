"""Liquid encodings: bit-plane primitives, linear integers, ALP floats,
FSST-backed string dictionaries, their squeezed forms and Liquid IPC."""
