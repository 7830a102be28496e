"""The MLP and the multi-level Model."""
