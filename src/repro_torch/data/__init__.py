"""Data (torch): the synthetic LM pipeline, prefetch and length bucketing."""
