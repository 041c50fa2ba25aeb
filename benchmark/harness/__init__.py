"""General parts of the benchmark: nothing here names a cell, a
configuration, a traffic mix or a per-layer metric."""
