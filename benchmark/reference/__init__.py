"""The plain reference: a path tracer and its hit queries in plain PyTorch,
which import nothing of the program under test, and the comparisons that
decide a run's `correct`."""
