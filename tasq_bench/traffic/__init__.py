"""Traffic: the frozen SCOPE-like generator (``generator``, ``executor``)
and ``build``, which reads a cell's traffic parameters and makes its
template pool, its arrivals and its query identities from the seed."""
