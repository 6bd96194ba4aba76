"""SQL frontend (host copies of the reference's parser, qualifier and
planner) and the fused scalar device path."""
