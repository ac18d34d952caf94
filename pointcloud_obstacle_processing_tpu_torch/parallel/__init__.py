"""Multi-scan batching (counterpart of the reference's ``parallel``)."""
