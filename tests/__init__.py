"""Test suite (a package, so `tests.*` imports resolve to this
directory even where another installed package is named `tests`)."""
