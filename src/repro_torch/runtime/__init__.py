"""Runtime services of the port: the elastic worker pool and the
straggler model."""
