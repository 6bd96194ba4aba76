"""Host utilities: lock factories and span tracing."""
