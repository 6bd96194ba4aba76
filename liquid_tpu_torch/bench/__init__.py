"""Data generators: TPC-H tables and the synthesized ClickBench hits."""
