"""Cache runtime: entries, budgets, policies, transcoding (memory tiers)."""
