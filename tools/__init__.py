"""Probes and benchmarks run as scripts (a package, so `tools.*`
imports resolve to this directory)."""
