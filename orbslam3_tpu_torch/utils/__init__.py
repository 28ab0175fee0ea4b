"""Host-side utilities: datasets, evaluation, timing, state conversion."""
