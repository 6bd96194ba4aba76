"""Developer tools: the cache-trace viewer (`trace_viz`)."""
