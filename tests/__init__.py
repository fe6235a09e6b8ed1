"""Test suite. A regular package, so `tests.helpers` and
`tests.reference_numpy` resolve to this checkout even where another
installed distribution ships a top-level `tests` package."""
