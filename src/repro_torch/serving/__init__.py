"""Serving: the continuous-batching engine, sampler and latency histograms."""
