"""Model math of the serving and training paths: configuration, layer
primitives (``blocks``), and the LM's forward pass and decode step
(``lm``)."""
