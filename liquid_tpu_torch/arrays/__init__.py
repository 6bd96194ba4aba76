"""Liquid encodings: bit-plane primitives, linear integers, ALP floats."""
