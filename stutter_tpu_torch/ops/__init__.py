"""Device operations: the attention kernel wrapper and its plain version, pooling."""
