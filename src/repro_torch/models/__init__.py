"""Model math of the serving path: configuration, decode-time layer
primitives (``blocks``) and the decode step of the LM (``lm``)."""
