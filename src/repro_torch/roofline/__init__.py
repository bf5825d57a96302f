"""Roofline accounting: hardware constants, per-step counts, the report."""
