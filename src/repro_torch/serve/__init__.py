"""Deterministic batched serving: decode slots commit page metadata as
preordered transactions (``session.Session``)."""
