"""Reference workloads shared by the port's checks and measurements
(``workloads``: the ``@zipf50k`` kernel shape)."""
