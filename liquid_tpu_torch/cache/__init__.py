"""Cache runtime: entries in five states, budgets, replacement, squeeze
and hydration policies, transcoding, the disk block store."""
