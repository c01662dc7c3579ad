"""The benchmark's general code: finding a cell's parts by name, seeded
weights, spans, the profiler trace, peaks, operation counts and the run
itself. Whatever belongs to one configuration, traffic mix, driver or
per-layer metric lives in a file of its own beside this package."""
