"""Runtime services of the port: the elastic worker pool, the straggler
model and the sharding profiles."""
