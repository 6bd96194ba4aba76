"""Parquet-facing cache integration."""
