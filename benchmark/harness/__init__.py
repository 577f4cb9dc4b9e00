"""The harness: finds a cell's configuration, traffic, metric readers and
kernel families by the names in ``BENCHMARK.json``, runs the cell and
prints its result line."""
