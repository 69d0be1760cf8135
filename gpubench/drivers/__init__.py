"""The traffic drivers: one module a kind of traffic, each with a ``Run`` (set-up, window, trace, check)."""
