"""The harness's general parts: finding cells, configurations, drivers and
metrics by name; the window's arithmetic; the trace's reduction."""
