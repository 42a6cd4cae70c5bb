"""Host utilities: checkpoint files, native IO, profiling, visualization."""
