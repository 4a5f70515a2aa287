"""Benchmark cases and the analytic FLOP and peak-rate accounting."""
